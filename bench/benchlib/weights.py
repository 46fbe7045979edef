"""Weights made by the benchmark from the seed, on the device, one call a
leaf in the type the leaf is served or trained in.  Leaf i of the tree
(in the walk order of ``walk``) draws from its own generator, seeded by
(seed, i), so any leaf can be made again alone and comes out the same.

Distributions, by the leaf's name: norm ``scale`` zeros (an RMSNorm of
``(1 + scale)``), biases N(0, 0.1^2), ``embed`` N(0, 1), every other
matrix N(0, 1 / fan_in) with fan_in its input width (q/k/v: the d axis
before (heads, hd); o: heads x hd)."""
from __future__ import annotations

import math
from typing import Any, Iterator, List, Tuple

import torch

Path = Tuple[Any, ...]


def walk(tree, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """(path, leaf) in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, path + (i,))
    else:
        yield path, tree


def rebuild(tree, leaves: List[Any]):
    """A tree of ``tree``'s structure holding ``leaves`` in walk order."""
    it = iter(leaves)

    def go(node):
        if isinstance(node, dict):
            return {k: go(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(go(v) for v in node)
        return next(it)
    return go(tree)


def fan_in(path: Path, shape) -> int:
    name = path[-1]
    if name in ("wq", "wk", "wv"):
        return shape[-3]
    if name == "wo":
        return shape[-3] * shape[-2]
    return shape[-2]


def make_leaf(path: Path, shape, dtype: torch.dtype, device, seed: int,
              index: int) -> torch.Tensor:
    name = path[-1]
    if name == "scale":
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 7919 * index + 1) % (2 ** 63))
    t = torch.randn(tuple(shape), generator=gen, dtype=dtype, device=device)
    if name in ("bq", "bk", "bv"):
        return t.mul_(0.1)
    if name == "embed":
        return t
    return t.mul_(1.0 / math.sqrt(fan_in(path, shape)))


def make_tree(specs, seed: int, device):
    """A tree of ``specs``'s structure (``meta`` tensors give shape and
    dtype) filled from the seed."""
    return rebuild(specs, [make_leaf(path, spec.shape, spec.dtype, device,
                                     seed, i)
                           for i, (path, spec) in enumerate(walk(specs))])
