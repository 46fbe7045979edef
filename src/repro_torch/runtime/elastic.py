"""Elastic scaling: re-lay a training state out on another mesh -- the
port of ``repro/runtime/elastic.py``.

When ranks join or leave, the state follows the new mesh.  Checkpoints
hold whole leaves, so resharding is restoring: ``restore_on_mesh`` reads
the newest checkpoint straight into the new mesh's shards.
``reshard_state`` re-lays a live state on the same ranks, for example from
a (2, 1) to a (1, 2) mesh: each leaf is gathered by its old spec and cut
by its new one, one leaf at a time.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

from ..checkpoint.checkpoint import CheckpointManager
from ..core import tree
from .sharding import (MeshRules, gather_leaf, is_spec, leaf_paths,
                       leaf_spec, shard_leaf, tree_specs)


def reshard_state(state: Any, new_rules: MeshRules, *, specs: Any,
                  mesh) -> Tuple[Any, Any]:
    """``state``, laid out by ``specs`` on ``mesh`` now, as the shards of
    ``new_rules.mesh``; each whole leaf passes through host memory.
    Returns (state, its new spec tree)."""
    flat, rebuild = tree.flatten(state)
    old, rebuild_specs = tree.flatten(specs, is_spec)
    out, new = [], []
    for leaf, path, spec in zip(flat, leaf_paths(state), old):
        whole = gather_leaf(leaf, spec, mesh, "cpu")
        new.append(leaf_spec(new_rules, path, tuple(whole.shape)))
        out.append(shard_leaf(whole, new[-1], new_rules.mesh))
        del whole
    return rebuild(out), rebuild_specs(new)


def restore_on_mesh(ckpt: CheckpointManager, state_like: Any,
                    new_rules: MeshRules) -> Tuple[Any, int, Dict]:
    """The newest checkpoint as the shards of ``new_rules.mesh``.
    ``state_like``: the state's structure with whole-leaf shapes and the
    dtypes to restore (tensors on any device, ``meta`` included).
    Returns (state, step, extra)."""
    return ckpt.restore(state_like, specs=tree_specs(new_rules, state_like),
                        mesh=new_rules.mesh)
