"""Prefix cache: a token-id trie mapping shared prompt prefixes to KV
page runs -- a copy of ``repro/launch/prefix.py`` (the port imports
nothing of the JAX package).

At production scale most traffic shares long system/tool prompts, and the
page-table indirection makes exploiting that reuse a pure host-side
change (kernels resolve ``(slot, page_idx)`` through tables and never
learn whether a physical page is private or shared).

Granularity is one FULL page: a node's key is the exact tuple of token
ids that filled one page during prefill, so a node's page is only ever
published once every position in it holds valid K/V.  A request's
partial final chunk is never inserted (its tail positions are not
prefilled yet and will be written by decode), but a *query* may match a
partial prefix of a published full page — the sharer then binds the page
and masks the tail through its own ``lengths``.

Refcount discipline: the trie is one holder.  ``insert`` takes a
reference on every newly published page (``PageAllocator.share``);
``evict``/``flush`` release it.  Eviction only touches childless nodes
whose page has refcount 1 (held by the trie alone) — pages still bound
by a slot are never pulled out from under it — oldest ``last_used``
first, so the cache behaves as an LRU over prefix tails.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("key", "page", "parent", "children", "last_used")

    def __init__(self, key: Optional[tuple], page: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: Dict[tuple, "_Node"] = {}
        self.last_used = 0


class PrefixCache:
    """Trie over page-sized token chunks -> physical page ids."""

    def __init__(self, page_size: int):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.page = int(page_size)
        self.root = _Node(None, None, None)
        self._tick = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.n_nodes = 0

    # ------------------------------------------------------------- helpers
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    @staticmethod
    def _chunk(tokens: Sequence, c: int, page: int) -> tuple:
        return tuple(int(t) for t in tokens[c * page:(c + 1) * page])

    def n_pages(self) -> int:
        """Pages currently referenced (one per node)."""
        return self.n_nodes

    # --------------------------------------------------------------- match
    def match(self, tokens: Sequence) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``.

        Returns ``(pages, covered)``: the page run for positions
        ``[0, covered)``.  ``covered`` is either page-aligned (full-chunk
        matches only) or exactly ``len(tokens)`` when the final partial
        chunk is a prefix of some published page — the fully-covered
        case, where the caller can skip prefill entirely and bind the
        last (for it, partial) page copy-on-write.
        """
        n = len(tokens)
        pg = self.page
        node = self.root
        pages: List[int] = []
        covered = 0
        full = True
        for c in range(n // pg):
            child = node.children.get(self._chunk(tokens, c, pg))
            if child is None:
                full = False
                break
            self._touch(child)
            pages.append(child.page)
            covered += pg
            node = child
        if full:
            rem = tuple(int(t) for t in tokens[(n // pg) * pg:])
            if rem:
                for key, child in node.children.items():
                    if key[:len(rem)] == rem:
                        self._touch(child)
                        pages.append(child.page)
                        covered = n
                        break
        if covered:
            self.hits += 1
        else:
            self.misses += 1
        return pages, covered

    # -------------------------------------------------------------- insert
    def insert(self, tokens: Sequence, pages: Sequence[int],
               allocator) -> int:
        """Publish ``tokens``'s fully-prefilled chunks.

        ``pages`` is the owning slot's logical page run; only the
        ``len(tokens) // page`` complete chunks are inserted (the partial
        tail chunk still takes decode writes, so publishing it would hand
        sharers unwritten positions).  Existing nodes are refreshed, not
        replaced (concurrent identical prompts race benignly: first
        publisher wins, the loser's pages stay private).  Returns the
        number of pages newly referenced.
        """
        pg = self.page
        node = self.root
        added = 0
        for c in range(len(tokens) // pg):
            key = self._chunk(tokens, c, pg)
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(pages[c]), node)
                node.children[key] = child
                allocator.share(child.page)
                self.n_nodes += 1
                added += 1
            self._touch(child)
            node = child
        return added

    # --------------------------------------------------------------- evict
    def _evictable(self, allocator) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif allocator.ref[node.page] == 1:
                out.append(node)
        return out

    def evict(self, n: int, allocator) -> int:
        """Free up to ``n`` pages held only by the trie, LRU-first.

        Only childless nodes are candidates (removing an interior node
        would orphan still-valid longer prefixes), so eviction proceeds
        leaf-inward; freeing a leaf can expose its parent next round.
        """
        freed = 0
        while freed < n:
            cands = self._evictable(allocator)
            if not cands:
                break
            victim = min(cands, key=lambda nd: nd.last_used)
            del victim.parent.children[victim.key]
            allocator.release([victim.page])
            self.n_nodes -= 1
            self.evictions += 1
            freed += 1
        return freed

    def flush(self, allocator) -> int:
        """Release every cached page (e.g. before a weight swap)."""
        freed = 0
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            allocator.release([node.page])
            freed += 1
        self.root.children.clear()
        self.n_nodes = 0
        return freed
