"""The port's sharding rules (``runtime/sharding.py``) against the JAX
package's, leaf for leaf.

For every arch of ``configs/archs.py`` at smoke size, as its smoke layer
list and as a stacked period layout, and on the meshes (1,1), (2,1),
(1,2), (2,2), (4,2) over ("data", "model") and (2,2,2) over ("pod",
"data", "model"): the port's ``tree_specs`` of the params, the AdamW state
(fp32 and int8 moments) and the compression residual equal JAX's
``tree_shardings`` specs, path for path.  JAX's ``tree_shardings`` needs
a real mesh, so it runs once, for every case, in a subprocess with 8
host devices (``helpers.run_multidevice``).  ``batch_spec``,
``activation_spec`` and each dense cache leaf's ``cache_spec`` only read
the mesh's shape, so both packages take a mesh-shaped stand-in here.
"""
import dataclasses
import json
import types

import pytest
import torch

from helpers import run_multidevice
from repro.runtime import sharding as jax_sharding
from repro_torch.configs import ARCHS
from repro_torch.core import tree
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.compress import init_residual
from repro_torch.runtime import sharding

torch.set_num_threads(1)
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "pod2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
LAYOUTS = ("smoke", "stacked")
TREES = ("params", "opt", "opt_int8", "residual")


def stacked(cfg):
    """``cfg`` with its distinct layer kinds as a period repeated twice
    (a leading period axis on every layer leaf)."""
    kinds = cfg.distinct_kinds()
    return dataclasses.replace(cfg, prefix=(), pattern=kinds,
                               n_layers=2 * len(kinds))


def standin(shape, axes):
    """What the rules read of a mesh: its shape by axis and axis names."""
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axes=tuple(axes), axis_names=tuple(axes))


def _plain(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


JAX_SPECS = """
    import dataclasses, json
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs.archs import ARCHS
    from repro.models.transformer import Model
    from repro.optim.adamw import AdamWConfig, adamw_init
    from repro.optim.compress import init_residual
    from repro.runtime.sharding import _path_str, make_rules, tree_shardings

    MESHES = %(meshes)s
    out = {}
    for arch, base in sorted(ARCHS.items()):
        for layout in ("smoke", "stacked"):
            cfg = base.smoke()
            if layout == "stacked":
                kinds = cfg.distinct_kinds()
                cfg = dataclasses.replace(cfg, prefix=(), pattern=kinds,
                                          n_layers=2 * len(kinds))
            model = Model(cfg)
            params = jax.eval_shape(model.init, jax.random.key(0))
            trees = {
                "params": params,
                "opt": jax.eval_shape(lambda p: adamw_init(
                    p, AdamWConfig()), params),
                "opt_int8": jax.eval_shape(lambda p: adamw_init(
                    p, AdamWConfig(int8_moments=True)), params),
                "residual": jax.eval_shape(init_residual, params)}
            for name, (shape, axes) in MESHES.items():
                n = int(np.prod(shape))
                mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                            axes)
                rules = make_rules(mesh, fsdp=True)
                for tname, tree in trees.items():
                    sh = tree_shardings(rules, tree)
                    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
                    out["/".join((arch, layout, name, tname))] = {
                        _path_str(p): [list(e) if isinstance(e, tuple)
                                       else e for e in s.spec]
                        for p, s in flat}
    with open(%(path)r, "w") as f:
        json.dump(out, f)
    print("SPECS-OK", len(out))
"""


@pytest.fixture(scope="module")
def jax_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("specs") / "jax_specs.json"
    meshes = {k: (list(s), list(a)) for k, (s, a) in MESHES.items()}
    out = run_multidevice(JAX_SPECS % {"meshes": meshes, "path": str(path)},
                          n_devices=8)
    assert "SPECS-OK" in out
    return json.loads(path.read_text())


def port_trees(arch, layout):
    cfg = ARCHS[arch].smoke()
    if layout == "stacked":
        cfg = stacked(cfg)
    params = Model(cfg, device="cpu").init(0)
    return {"params": params,
            "opt": adamw_init(params, AdamWConfig()),
            "opt_int8": adamw_init(params, AdamWConfig(int8_moments=True)),
            "residual": init_residual(params)}


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_trees_match_jax(arch, layout, jax_specs):
    trees = port_trees(arch, layout)
    for name, (shape, axes) in MESHES.items():
        rules = sharding.make_rules(standin(shape, axes), fsdp=True)
        for tname, tree in trees.items():
            specs = sharding.tree_specs(rules, tree)
            got = {p: _plain(s) for p, s in zip(
                sharding.leaf_paths(tree), sharding.spec_leaves(specs))}
            want = jax_specs["/".join((arch, layout, name, tname))]
            assert got == want, (arch, layout, name, tname)


def test_specs_shard_what_the_mesh_splits(jax_specs):
    """The parity above is not vacuous: on (2,2) FSDP stripes the MLP's
    weights over data and model, int8 scales keep the param's rule, and a
    size-1 axis shards nothing."""
    want = jax_specs["gemma-2b/stacked/2x2/opt_int8"]
    assert want["m.stack.0.mlp.wg.q"] == [None, "data", "model"]
    assert want["m.stack.0.mlp.wg.scale"] == [None, "data", "model"]
    assert want["count"] == []
    assert all(e is None for spec in
               jax_specs["gemma-2b/stacked/1x1/params"].values()
               for e in spec)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_activation_and_cache_specs_match_jax(mesh):
    shape, axes = MESHES[mesh]
    ours = sharding.make_rules(standin(shape, axes), fsdp=True)
    theirs = jax_sharding.make_rules(standin(shape, axes), fsdp=True)
    for rows in (1, 2, 3, 4, 8, 12):
        for dims in ((rows,), (rows, 32), (rows, 32, 128), (rows, 1, 128)):
            assert tuple(ours.batch_spec(dims)) == \
                tuple(theirs.batch_spec(dims)), dims
            a, b = ours.activation_spec(dims), theirs.activation_spec(dims)
            assert (a is None and b is None) or tuple(a) == tuple(b), dims
    for arch in sorted(ARCHS):
        for layout in LAYOUTS:
            cfg = ARCHS[arch].smoke()
            cfg = stacked(cfg) if layout == "stacked" else cfg
            cache = Model(cfg, device="cpu").init_cache(4, 32)
            for path, leaf in zip(sharding.leaf_paths(cache),
                                  tree.leaves(cache)):
                want = theirs.cache_spec(path, tuple(leaf.shape))
                assert tuple(ours.cache_spec(path, tuple(leaf.shape))) \
                    == tuple(want), (arch, layout, path)


def test_paths_are_jax_key_paths():
    """List indices stay in the path (``tp.map_named`` drops them),
    NamedTuple fields and ``QuantizedBlock`` leaves are named, as JAX's
    ``_path_str`` prints them."""
    params = Model(stacked(ARCHS["gemma-2b"].smoke()), device="cpu").init(0)
    opt = (adamw_init(params, AdamWConfig(int8_moments=True)),
           init_residual(params))
    paths = sharding.leaf_paths(opt)
    assert "0.count" in paths
    assert "0.m.stack.0.attn.wq.q" in paths
    assert "0.v.stack.0.mlp.wd.scale" in paths
    assert "1.stack.0.attn.wq" in paths
    assert len(paths) == len(sharding.spec_leaves(
        sharding.tree_specs(sharding.make_rules(standin((2, 2), (
            "data", "model"))), opt)))


def test_shard_and_gather_state_round_trip_on_one_rank():
    """On the local one-rank mesh every spec replicates: the shards are
    the leaves themselves, and gathering gives them back."""
    mesh = Mesh((1, 1), ("data", "model"), torch.device("cpu"), "local")
    params = Model(ARCHS["gemma-2b"].smoke(), device="cpu").init(0)
    specs = sharding.tree_specs(sharding.make_rules(mesh), params)
    assert all(e is None for s in sharding.spec_leaves(specs) for e in s)
    shards = sharding.shard_state(params, specs, mesh)
    back = sharding.gather_state(shards, specs, mesh)
    for a, s, b in zip(tree.leaves(params), tree.leaves(shards),
                       tree.leaves(back)):
        assert s is a and b is not a and torch.equal(a, b)
    assert sharding.batch_axes(sharding.make_rules(mesh), 4) == ()
