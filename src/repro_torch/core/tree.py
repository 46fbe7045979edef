"""Flatten and rebuild the port's state trees: nested dicts (keys in
sorted order, as JAX flattens them), lists, tuples and NamedTuples, with
``QuantizedBlock`` as a node of its (q, scale) leaves.  Every other object
is a leaf.  What checkpoints, the optimizer and the train step walk."""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

from .memory import QuantizedBlock

IsLeaf = Optional[Callable[[Any], bool]]


def flatten(tree: Any, is_leaf: IsLeaf = None
            ) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves in a fixed order, rebuild): ``rebuild(leaves)`` returns a
    tree of ``tree``'s structure holding the given leaves.  ``is_leaf``
    stops the walk at the nodes it accepts."""
    leaves: List[Any] = []

    def walk(node) -> Callable:
        if is_leaf is not None and is_leaf(node):
            leaves.append(node)
            return next
        if isinstance(node, dict):
            keys = sorted(node)
            subs = [walk(node[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(node, QuantizedBlock):
            q, scale, block = walk(node.q), walk(node.scale), node.block
            return lambda it: QuantizedBlock(q(it), scale(it), block)
        if isinstance(node, (list, tuple)):
            subs = [walk(v) for v in node]
            kind = type(node)
            if hasattr(node, "_fields"):                  # NamedTuple
                return lambda it: kind(*[s(it) for s in subs])
            return lambda it: kind(s(it) for s in subs)
        leaves.append(node)
        return next

    build = walk(tree)
    # ``walk`` reaches itself through its closure; left bound, that cycle
    # would hold every leaf (a step's gradients, a run's whole state) until
    # the cycle collector happens to run
    del walk
    return leaves, lambda new: build(iter(new))


def leaves(tree: Any, is_leaf: IsLeaf = None) -> List[Any]:
    return flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the leaves of ``tree``, in a tree of its structure."""
    flat, rebuild = flatten(tree)
    return rebuild([fn(leaf) for leaf in flat])
