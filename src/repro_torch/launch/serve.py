"""Batched serving: the port of ``repro/launch/serve.py``.

The KV cache is a pool of fixed-size pages (paper §4.3 memory banking); a
host-side scheduler does admission control (a request is admitted only
when its whole lifetime's pages can be reserved), chunked prefill (the
ragged multi-token prefill kernel), batched decode over ragged lengths
(every slot at its own position, the ragged decode kernel), sliding-window
page reclamation and slot recycling.  The scheduler computes addresses
(page tables); the kernels only ever see dense tiles.  With
``--prefix-cache`` requests share the KV pages of common prompt prefixes
(refcounted pages, copy-on-write appends, prefill skipping); with
``--kv-dtype int8`` the pools hold int8 pages with per-(page, kv head)
scales, and ``--weights-dtype int8`` runs every projection and MLP GEMM on
int8 weights (type demotion, paper §4.4); MoE layers (router, experts,
shared MLP) stay float, as in the JAX package.

Two cache layouts (``--cache {dense,paged}``; dense is the default, as in
the JAX package): ``dense`` is ``Server``, one rectangular (slots,
max_len) cache (rolling buffers for windowed layers) with prompts
teacher-forced through the decode step one token at a time; ``paged`` is
``PagedScheduler`` over the page pool.  ``--speculate {ngram,model}``
(paged) replaces each decode step by draft, one batched verify forward
and host rollback (``launch/speculative.py``).

Two paged schedules (``--schedule {static,continuous}``):

* ``static`` -- ``PagedScheduler.run``: admit a static request list,
  whole-prompt prefill on admission, decode rounds to completion.
* ``continuous`` -- ``launch/engine.ContinuousEngine``: requests arrive
  on a virtual clock, each iteration composes multi-slot prefill chunks
  and decode steps under a token budget, and ``launch/metrics`` records
  TTFT and per-token latency percentiles.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --cache paged --schedule continuous --requests 6 --prompt-len 100 \\
      --max-new 16 --max-len 256    # on the CUDA card (the default)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --smoke --device cpu          # dense, the plain versions on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --smoke --device cpu --cache paged --speculate ngram
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --cache paged --kv-dtype int8 --weights-dtype int8 --prefix-cache \\
      --shared-prefix-len 64 --shared-frac 1.0 --prompt-len 100 \\
      --max-len 256                 # int8 + prefix sharing on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..configs import get_arch
from ..core.memory import DtypePolicy
from ..core.quant import kv_dtype_of
from ..kernels import dispatch
from ..models.transformer import Model, paged_supported
from ..runtime import tp as tp_mod
from .loadgen import Request, poisson_stream
from .prefix import PrefixCache
from .speculative import accept_longest_prefix, make_drafter

DEFAULT_PAGE_SIZE = 64


def pick_page_size(backend: Optional[str] = None, *,
                   hkv: Optional[int] = None, dtype: Any = None,
                   max_len: Optional[int] = None) -> int:
    """The pool layout from the tuned decode plans (the layout is a
    tunable, §3.4): among the plan cache's ``decode_attention`` entries
    for this card (``backend``: its name, as the cache keys hold it;
    default the current card, or ``cpu``), the page size of the lowest
    ``us``; ``DEFAULT_PAGE_SIZE`` when nothing was tuned.  The port's
    decode key holds the page in its shape (n_pages, page, Hkv), so the
    page is read from the key.  ``hkv``, ``dtype`` (the pools') and
    ``max_len`` (a table of ``ceil(max_len / page)`` pages) keep only the
    entries of the problem being served, so that timings of different
    sizes are not compared; the JAX package's pick, with none of them
    given, compares every entry."""
    from ..tune import cache as tune_cache
    cache = tune_cache.default_cache()
    backend = tune_cache._backend_name(backend)
    dtype = None if dtype is None else tune_cache._dtype_name(dtype)
    best_us, best_page = float("inf"), 0
    for key, entry in cache.entries.items():
        try:
            kernel, shape, kd, kb = tune_cache.parse_key(key)
        except ValueError:
            continue
        if kernel != "decode_attention" or kb != backend or len(shape) != 3:
            continue
        n_pages, page, key_hkv = shape
        if not page or (hkv is not None and key_hkv != hkv) \
                or (dtype is not None and kd != dtype) \
                or (max_len is not None and n_pages != -(-max_len // page)):
            continue
        us = entry.get("us", float("inf"))
        if us < best_us:
            best_us, best_page = us, page
    return best_page or DEFAULT_PAGE_SIZE


def _silent(*args, **kwargs) -> None:
    """The report printer of ranks other than 0."""


class Server:
    """Fixed-slot continuous-batching decoder over a dense rectangular
    cache (``--cache dense``): prompts are teacher-forced through the
    decode step one token at a time, every slot at one shared ``pos``;
    each attention layer reads its cache through the ragged decode kernel
    (``layers.attention_decode``).  The shared position is also the
    context wall: at ``max_len - 1`` the run stops, requests in flight are
    returned truncated and requests never admitted are counted
    rejected."""

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 log=print):
        self.model = model
        # int8 weights are quantized here, once (Model.bind_params)
        self.params = model.bind_params(params)
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.log = log or (lambda *a, **k: None)
        self.cache = model.init_cache(slots, max_len)
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = 0
        self.truncated = 0                # requests cut short at the wall
        self.rejected = 0                 # unserved at the wall, counted
        self.rejected_requests: List[Request] = []
        self.decode_steps = 0
        self.decode_seconds = 0.0         # host wall, argmax read included

    def step(self, tokens: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int32))
        logits = self.model.decode_step(
            self.params, self.cache, toks.to(self.device)[:, None],
            pos=self.pos)
        self.pos += 1
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.decode_steps += 1
        self.decode_seconds += time.perf_counter() - t0
        return nxt

    def run(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        cur = np.zeros((self.slots,), np.int32)
        prompt_cursor = np.zeros((self.slots,), np.int64)
        done: List[Request] = []
        while queue or any(r is not None for r in self.active):
            # fill free slots (continuous batching)
            for i in range(self.slots):
                if self.active[i] is None and queue:
                    self.active[i] = queue.pop(0)
                    prompt_cursor[i] = 0
                    cur[i] = self.active[i].prompt[0]
            nxt = self.step(cur)
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                prompt_cursor[i] += 1
                if prompt_cursor[i] < len(r.prompt):
                    cur[i] = r.prompt[prompt_cursor[i]]   # teacher-forced
                else:
                    r.out.append(int(nxt[i]))
                    cur[i] = nxt[i]
                    if len(r.out) >= r.max_new or self.pos >= self.max_len - 1:
                        r.done = True
                        r.truncated = len(r.out) < r.max_new
                        if r.truncated:
                            self.truncated += 1
                        done.append(r)
                        self.active[i] = None
            if self.pos >= self.max_len - 1:
                break
        # the context wall: the shared pos hit max_len with work in flight.
        # Requests caught mid-prompt or mid-generation are returned
        # flagged, and requests never admitted are counted rejected
        for i, r in enumerate(self.active):
            if r is None:
                continue
            r.done = True
            r.truncated = True
            self.truncated += 1
            done.append(r)
            self.active[i] = None
            self.log(f"[dense] truncating request {r.rid} at the "
                     f"context wall (max_len={self.max_len}, "
                     f"{len(r.out)} tokens out)")
        for r in queue:
            r.done = False
            self.rejected += 1
            self.rejected_requests.append(r)
            self.log(f"[dense] rejecting request {r.rid}: context wall "
                     f"reached before admission (max_len={self.max_len})")
        return done


class PageAllocator:
    """Host-side refcounted free list over the shared page pool.

    Physical page 0 is reserved as the TRASH page: inactive slots' tables
    point every logical page at it, so their masked decode writes can
    never corrupt a live sequence.

    Every live page carries a reference count: ``alloc`` hands out pages
    at refcount 1, ``share`` adds a holder (another slot's table binding,
    or the prefix cache), and ``release`` drops one -- the page only
    returns to the free list when its last holder lets go.
    """

    def __init__(self, total_pages: int):
        self.total = total_pages
        self._free = list(range(total_pages - 1, 0, -1))
        self.ref = [0] * total_pages
        # called with the page list every ``alloc`` hands out: the paged
        # scheduler resets int8 scale rows here, so a recycled page's stale
        # scales never leak into its next sequence (copy-on-write copies
        # its payload AFTER alloc, so copied scales survive the reset)
        self.on_alloc = None

    def available(self) -> int:
        return len(self._free)

    def held(self) -> int:
        """Pages with at least one holder (excl. the trash page)."""
        return sum(1 for p in range(1, self.total) if self.ref[p] > 0)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)}")
        got, self._free = self._free[-n:], self._free[:-n]
        got = got[::-1]
        for p in got:
            assert self.ref[p] == 0, f"page {p} allocated while referenced"
            self.ref[p] = 1
        if got and self.on_alloc is not None:
            self.on_alloc(got)
        return got

    def share(self, page: int) -> None:
        assert self.ref[page] > 0, f"cannot share free page {page}"
        self.ref[page] += 1

    def release(self, pages: List[int]) -> None:
        for p in reversed(pages):
            assert self.ref[p] > 0, f"double free of page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(p)


def _cache_leaves(cache) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every pool leaf: ``k_pages``/``v_pages``
    (P, page, Hkv, hd) and, for int8 pools, ``k_scale``/``v_scale``
    (P, Hkv); stacked periods carry a leading period axis (ndim 5 / 3)."""
    for group in ("prefix", "stack", "tail"):
        for layer in cache[group]:
            yield from layer.items()


def _pool_axis(leaf: torch.Tensor) -> int:
    return 1 if leaf.ndim in (3, 5) else 0


def _copy_cache_page(cache, src: int, dst: int) -> None:
    """Copy one physical page across every layer's pools, in place (the
    copy-on-write payload).  Scale rows ride the same copy, so a copied
    page dequantizes as its source does."""
    for _, leaf in _cache_leaves(cache):
        if _pool_axis(leaf):
            leaf[:, dst] = leaf[:, src]
        else:
            leaf[dst] = leaf[src]


def _reset_page_scales(cache, pages: List[int]) -> None:
    """Zero the int8 scale rows of freshly allocated pages, in place.  A
    recycled page still holds its previous sequence's payload and scales;
    ``append_token_quantized`` treats scale 0 as an empty page and wipes
    the stale payload on the first write, so this reset is what makes
    page reuse sound under quantization.  No-op for float pools."""
    idx = torch.tensor(pages, dtype=torch.long)
    for name, leaf in _cache_leaves(cache):
        if name.endswith("_scale"):
            idx = idx.to(leaf.device)
            if _pool_axis(leaf):
                leaf[:, idx] = 0.0
            else:
                leaf[idx] = 0.0


def _page_bytes(cache) -> int:
    """Bytes ONE physical page occupies across every pool leaf: K/V pages
    at the storage dtype plus any scale rows."""
    total = 0
    for _, leaf in _cache_leaves(cache):
        ax = _pool_axis(leaf)
        total += leaf.numel() // leaf.shape[ax] * leaf.element_size()
    return total


class PagedScheduler:
    """Admission, chunked prefill, batched ragged decode, slot recycling.

    With ``prefix_cache=True`` the scheduler also shares KV pages across
    requests: finished prefills publish their full pages into a token-id
    trie (``launch/prefix.PrefixCache``), ``reserve`` binds a new
    request's leading table rows to matching cached pages (refcounted,
    prefill skipped for covered chunks), and a decode append into a page
    with other holders copies it first (copy-on-write).  The kernels
    resolve ``(slot, page_idx)`` through the same tables either way.
    """

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 page_size: int = 0, total_pages: int = 0,
                 prefix_cache: bool = False, mesh=None, log=print):
        if not paged_supported(model.cfg):
            raise ValueError(
                f"arch {model.cfg.name} has recurrent/stateful layers; "
                "paged serving requires attention-family stacks "
                "(use --cache dense)")
        self.model = model
        # ---- tensor parallelism (runtime/tp.py): a mesh shards the params
        # and the pools over its "model" axis and swaps the step functions
        # for their sharded twins; the host metadata (tables, lengths,
        # allocator, trie) is the same on every rank, so nothing else
        # changes
        self.mesh = mesh
        self.tp = mesh.shape["model"] if mesh is not None else 1
        self._sharded = None
        if mesh is not None:
            err = tp_mod.tp_error(model.cfg, self.tp)
            if err:
                raise ValueError(err)
            params = tp_mod.shard_params(params, model.cfg, mesh)
            self._sharded = tp_mod.sharded_paged_fns(model, mesh)
        # int8 weights are quantized here, once (Model.bind_params); under
        # a mesh from each rank's own shard, as the JAX package quantizes
        # inside its shard_map body (a row-parallel wd shard carries the
        # scales of its own K slice)
        self.params = model.bind_params(params)
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.log = log or (lambda *a, **k: None)
        # the rank's pools: Hkv / tp heads where they shard
        hkv = model.cfg.n_kv_heads // (
            self.tp if tp_mod.kv_sharded(model.cfg, self.tp) else 1)
        self.page = page_size or model.cfg.kv_page_size or pick_page_size(
            hkv=hkv, dtype=kv_dtype_of(model.cfg.kv_dtype, model.dt.compute),
            max_len=max_len)
        self.n_slot_pages = -(-max_len // self.page)
        total = total_pages or 1 + slots * self.n_slot_pages
        self.alloc = PageAllocator(total)
        self.cache = model.init_paged_cache(slots, max_len, self.page,
                                            total_pages=total)
        # bytes of one page over the whole mesh, as the JAX package counts
        # them on its global arrays
        self._page_bytes = _page_bytes(self.cache)
        if mesh is not None:
            self.cache = tp_mod.shard_cache(self.cache, model.cfg, mesh)
        # int8 pools carry per-page scale rows; their lifecycle is slaved
        # to the allocator via on_alloc (reset on reuse); copy-on-write
        # copies and resets index the page axis, so under a mesh they act
        # on each rank's own slice
        if any(name.endswith("_scale")
               for name, _ in _cache_leaves(self.cache)):
            self.alloc.on_alloc = self._reset_scales
        self.table = np.zeros((slots, self.n_slot_pages), np.int32)
        self.lengths = np.zeros((slots,), np.int32)
        self.active: List[Optional[Request]] = [None] * slots
        self.slot_pages: List[List[int]] = [[] for _ in range(slots)]
        # sliding-window page reclamation: only sound when EVERY attention
        # layer is windowed (a single global-attention layer reads the
        # whole history, so its pages are never dead)
        self.window = model.cfg.window if all(
            m == "swa" for m, _ in model.cfg.layer_kinds()) else 0
        self.reclaimed = [0] * slots      # leading logical pages freed
        self.pages_reclaimed = 0
        self.prefill_tokens = 0
        self.decode_steps = 0
        self.decode_tokens = 0
        # ---- speculative decoding (launch/speculative.py) ----
        self.verify_steps = 0             # batched verify forwards
        self.verify_seconds = 0.0         # their host wall, argmax included
        self.draft_seconds = 0.0          # the drafter's proposals
        self.spec_drafted = 0             # candidate tokens proposed
        self.spec_accepted = 0            # candidates the target agreed with
        self.spec_emitted = 0             # tokens emitted by verify steps
        self.rejected = 0                 # inadmissible requests, counted
        self.rejected_requests: List[Request] = []
        self.truncated = 0                # finished early at max_len
        # ---- prefix sharing (refcounted pages + copy-on-write) ----
        self.prefix = PrefixCache(self.page) if prefix_cache else None
        self.shared_tokens = np.zeros((slots,), np.int64)
        self.shared_tokens_total = 0      # prompt tokens never prefilled
        self.cow_copies = 0
        # a fully-covered request's first decode appends into a shared
        # page; its copy-on-write page is reserved at admission so a
        # request still never stalls mid-decode
        self.cow_stash: List[List[int]] = [[] for _ in range(slots)]

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as an int32 tensor on the model's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def decode_forward(self, tokens: torch.Tensor, paged) -> torch.Tensor:
        """``Model.decode_step`` over the paged cache, or its sharded twin
        under a mesh: logits (slots, V)."""
        fn = self._sharded[0] if self._sharded else self.model.decode_step
        return fn(self.params, self.cache, tokens, paged=paged)

    def prefill_forward(self, *args: torch.Tensor) -> torch.Tensor:
        """``Model.prefill_step_paged(params, cache, tokens, starts,
        tables, last)``, or its sharded twin under a mesh."""
        fn = self._sharded[1] if self._sharded \
            else self.model.prefill_step_paged
        return fn(self.params, self.cache, *args)

    def step_seconds(self, seconds: float) -> float:
        """The step time every rank's clock advances by: rank 0's under a
        mesh of several ranks (each rank measures its own; a clock of its
        own would admit requests on other iterations than its peers')."""
        if self.mesh is None or self.mesh.size == 1:
            return seconds
        return self.mesh.group("model").broadcast_float(seconds,
                                                        self.device)

    # ------------------------------------------------------------ admission
    def pages_needed(self, r: Request) -> int:
        """Lifetime page budget, clamped to the context window."""
        return -(-min(len(r.prompt) + r.max_new, self.max_len) // self.page)

    def admissible(self, r: Request) -> bool:
        """Can this request EVER be admitted?  Its prompt must leave room
        to generate at least one token inside ``max_len``, and its
        lifetime page budget must fit one slot's table and the pool
        (minus the trash page)."""
        return (len(r.prompt) < self.max_len
                and self.pages_needed(r) <= min(self.n_slot_pages,
                                                self.alloc.total - 1))

    def _reject_reason(self, r: Request) -> str:
        if len(r.prompt) >= self.max_len:
            return (f"prompt {len(r.prompt)} tokens >= max_len "
                    f"{self.max_len}")
        return (f"needs {self.pages_needed(r)} pages "
                f"(> {self.n_slot_pages}/slot or pool)")

    def reserve(self, r: Request, slot: int) -> bool:
        """Reserve the request's whole-lifetime pages up front (a request
        never stalls mid-decode on an empty free list) and bind it to
        ``slot``.  Prefill is the caller's business.

        With a prefix cache, matching cached pages are bound shared
        (refcounted) instead of allocated: ``shared_tokens[slot]`` tells
        the caller how many leading prompt tokens already hold valid K/V
        -- prefill starts there.  When the cache covers the whole prompt
        the request also reserves one copy-on-write page (its first
        decode append lands mid-page in shared memory)."""
        need = self.pages_needed(r)
        if need > self.n_slot_pages:
            return False
        shared: List[int] = []
        covered = 0
        if self.prefix is not None:
            shared, covered = self.prefix.match(r.prompt)
            # pin before any eviction below can free them out from under us
            for p in shared:
                self.alloc.share(p)
        n_cow = 1 if covered >= len(r.prompt) else 0
        n_priv = need - len(shared) + n_cow
        if self.alloc.available() < n_priv and self.prefix is not None:
            self.prefix.evict(n_priv - self.alloc.available(), self.alloc)
        if self.alloc.available() < n_priv:
            self.alloc.release(shared)     # unpin: admission failed
            return False
        pages = self.alloc.alloc(n_priv)
        self.cow_stash[slot] = pages[need - len(shared):]
        pages = shared + pages[:need - len(shared)]
        self.slot_pages[slot] = pages
        self.reclaimed[slot] = 0
        self.table[slot] = 0
        self.table[slot, :need] = pages
        self.lengths[slot] = 0
        self.active[slot] = r
        self.shared_tokens[slot] = covered
        self.shared_tokens_total += covered
        self.check_page_accounting()
        return True

    def try_admit(self, r: Request, slot: int) -> bool:
        """Static-schedule admission: reserve, then chunk-prefill the
        (non-shared tail of the) prompt to completion.  A fully-covered
        prompt skips prefill: its first token is born from one masked
        ragged decode of the last prompt token (also the copy-on-write
        moment for the shared page it lands in)."""
        if not self.reserve(r, slot):
            return False
        ln = len(r.prompt)
        start = int(self.shared_tokens[slot])
        if start >= ln:
            self.lengths[slot] = ln - 1
            first = self._first_token_via_decode(slot, int(r.prompt[ln - 1]))
        else:
            first = self._prefill_prompt(r, slot, start=start)
        self.lengths[slot] = ln
        self.cache_prefix(slot, r.prompt)
        r.out.append(first)
        self._reclaim_slot(slot)    # long prompts can outrun the window
        return True

    def _prefill_prompt(self, r: Request, slot: int, start: int = 0) -> int:
        """Chunked prefill, one page per forward, from page-aligned
        ``start`` (shared leading chunks already hold valid K/V); returns
        the first generated token from the last real prompt position's
        logits."""
        ln = len(r.prompt)
        padded = -(-ln // self.page) * self.page
        toks = np.zeros((padded,), np.int32)
        toks[:ln] = r.prompt
        table_row = self._dev(self.table[slot:slot + 1])
        logits = None
        for t0 in range(start, ln, self.page):
            last = min(ln, t0 + self.page) - 1 - t0
            logits = self.prefill_forward(
                self._dev(toks[None, t0:t0 + self.page]), self._dev([t0]),
                table_row, self._dev([last]))
        self.prefill_tokens += ln - start
        return int(torch.argmax(logits[0]).item())

    def _first_token_via_decode(self, slot: int, token: int) -> int:
        """One masked ragged decode advancing only ``slot`` (other slots'
        ride-along writes land on the trash page): teacher-forces the
        last prompt token at position ``lengths[slot]`` and returns the
        argmax of its logits -- the fully-covered admission's first
        token."""
        self.prepare_decode([slot])
        mask = np.zeros((self.slots,), bool)
        mask[slot] = True
        lengths = np.where(mask, self.lengths, 0).astype(np.int32)
        table = np.where(mask[:, None], self.table, 0).astype(np.int32)
        cur = np.zeros((self.slots,), np.int32)
        cur[slot] = token
        nxt = self.step(cur, view=(lengths, table))
        return int(nxt[slot])

    # --------------------------------------------------- prefix sharing
    def cache_prefix(self, slot: int, prompt) -> None:
        """Publish the slot's fully-prefilled prompt chunks into the
        prefix trie (no-op without a cache)."""
        if self.prefix is None:
            return
        self.prefix.insert(prompt, self.slot_pages[slot], self.alloc)
        self.check_page_accounting()

    def _cow_page(self, slot: int, idx: int) -> None:
        """Give ``slot`` a private copy of its logical page ``idx`` if the
        page has other holders (prefix cache or sharer slots): stashed
        page first, then eviction-backed allocation; payload and int8
        scale rows copied, table rebound, source released."""
        src = self.slot_pages[slot][idx]
        if self.alloc.ref[src] <= 1:
            return
        if self.cow_stash[slot]:
            dst = self.cow_stash[slot].pop()
        else:
            need = 1 - self.alloc.available()
            if need > 0 and self.prefix is not None:
                self.prefix.evict(need, self.alloc)
            dst = self.alloc.alloc(1)[0]
        _copy_cache_page(self.cache, src, dst)
        self.slot_pages[slot][idx] = dst
        self.table[slot, idx] = dst
        self.alloc.release([src])
        self.cow_copies += 1
        self.check_page_accounting()

    def prepare_decode(self, slots: List[int]) -> None:
        """Copy-on-write sweep before a batched decode step: a slot whose
        next append position sits in a page with other holders gets a
        private copy first, so the write never touches a shared prefix."""
        for slot in slots:
            idx = int(self.lengths[slot]) // self.page
            if idx >= len(self.slot_pages[slot]):
                continue                 # guard: decode loop ends the req
            self._cow_page(slot, idx)

    def prepare_verify(self, slots: List[int], width: int) -> None:
        """Copy-on-write sweep before a batched verify step.  A verify
        window writes the whole fixed-width span ``[lengths, lengths +
        width)``, padded rows included, so every reserved page the span
        touches is made private first, not just the page under the
        cursor.  Pages past the reserved span take the model's trash-page
        redirect and need no copy; reclaimed leading pages lie below the
        span."""
        for slot in slots:
            lo = int(self.lengths[slot]) // self.page
            hi = min((int(self.lengths[slot]) + width - 1) // self.page,
                     len(self.slot_pages[slot]) - 1)
            for idx in range(max(lo, self.reclaimed[slot]), hi + 1):
                self._cow_page(slot, idx)

    def _reclaim_slot(self, slot: int) -> int:
        """Sliding-window page reclamation (delay buffering §2.2 applied
        to the cache): once every attention layer is windowed, a page
        whose last position sits wholly behind ``lengths - window`` can
        never be read again.  Free it now (its table entry moves to the
        trash page) instead of holding it until the request retires.
        Returns the number of pages freed."""
        if not self.window or not self.slot_pages[slot]:
            return 0
        # logical page p covers [p*page, (p+1)*page); dead iff
        # (p+1)*page <= lengths - window  (conservative by one position)
        dead = max(0, (int(self.lengths[slot]) - self.window) // self.page)
        dead = min(dead, len(self.slot_pages[slot]))
        freed = 0
        while self.reclaimed[slot] < dead:
            j = self.reclaimed[slot]
            self.alloc.release([self.slot_pages[slot][j]])
            self.table[slot, j] = 0          # -> trash page (masked reads)
            self.reclaimed[slot] += 1
            freed += 1
        if freed:
            self.pages_reclaimed += freed
            self.check_page_accounting()
        return freed

    def _reset_scales(self, pages: List[int]) -> None:
        """Allocator ``on_alloc`` hook: zero the scale rows of every page
        the allocator just handed out (see ``_reset_page_scales``)."""
        _reset_page_scales(self.cache, pages)

    def held_pages(self) -> int:
        """Physical pages with at least one holder (excl. trash page 0);
        a page shared by several holders counts once."""
        return self.alloc.held()

    def kv_bytes_resident(self) -> int:
        """Bytes of KV pool held by live pages at the storage dtype (pools
        plus scale rows): the residency that makes fp32, bf16 and int8
        serving comparable."""
        return self.held_pages() * self._page_bytes

    def check_page_accounting(self) -> None:
        """Invariant, refcount-aware: every page is free, held or the
        trash page; the total reference count equals the holders we can
        name (slot bindings, one per sharing slot; reserved copy-on-write
        pages; prefix-trie nodes); every active slot's cursor sits inside
        its live binding; and every int8 pool has its scale leaf."""
        held = self.held_pages()
        free = self.alloc.available()
        assert held + free + 1 == self.alloc.total, (
            f"page accounting broken: held={held} free={free} "
            f"trash=1 != total={self.alloc.total}")
        expected = (sum(len(p) - r for p, r in zip(self.slot_pages,
                                                   self.reclaimed))
                    + sum(len(s) for s in self.cow_stash)
                    + (self.prefix.n_pages() if self.prefix else 0))
        refs = sum(self.alloc.ref[1:])
        assert refs == expected, (
            f"refcount accounting broken: sum(ref)={refs} != "
            f"slot bindings + cow stash + trie = {expected}")
        for slot, r in enumerate(self.active):
            if r is None:
                continue
            ln = int(self.lengths[slot])
            span = len(self.slot_pages[slot]) * self.page
            assert ln <= span, (
                f"slot {slot} cursor {ln} past reserved span {span}")
            assert ln >= self.reclaimed[slot] * self.page, (
                f"slot {slot} cursor {ln} behind reclaimed frontier "
                f"{self.reclaimed[slot] * self.page}")
        self._check_scale_lockstep()

    def _check_scale_lockstep(self) -> None:
        """Every int8 pages leaf carries a companion scale leaf over the
        same pool: scales are allocated and recycled with their pages."""
        for group in ("prefix", "stack", "tail"):
            for layer in self.cache[group]:
                for k in ("k_pages", "v_pages"):
                    v = layer[k]
                    if v.dtype != torch.int8:
                        continue
                    s = layer.get(k[0] + "_scale")
                    assert s is not None, (
                        f"int8 pool {k} has no companion {k[0]}_scale")
                    assert s.shape[_pool_axis(s)] == v.shape[_pool_axis(v)], (
                        f"scale pool {s.shape} != page pool {v.shape} "
                        f"for {k}")

    def _recycle(self, slot: int) -> None:
        self.alloc.release(self.slot_pages[slot][self.reclaimed[slot]:]
                           + self.cow_stash[slot])
        self.slot_pages[slot] = []
        self.cow_stash[slot] = []
        self.reclaimed[slot] = 0
        self.table[slot] = 0
        self.lengths[slot] = 0
        self.shared_tokens[slot] = 0
        self.active[slot] = None
        self.check_page_accounting()

    # --------------------------------------------------------------- decode
    def step(self, tokens: np.ndarray, view=None) -> np.ndarray:
        """One batched ragged decode step: every active slot advances at
        its own length; inactive slots ride along masked (trash page).

        ``view`` = (lengths, table) overrides the scheduler's canonical
        arrays -- the continuous engine masks mid-prefill slots to zero
        length and the trash page so their ride-along writes are inert.
        """
        lengths, table = view if view is not None \
            else (self.lengths, self.table)
        logits = self.decode_forward(
            self._dev(tokens)[:, None],
            (self._dev(lengths), self._dev(table)))
        self.decode_steps += 1
        self.decode_tokens += int(np.count_nonzero(lengths))
        return torch.argmax(logits, dim=-1).cpu().numpy()

    # --------------------------------------------------- speculative decoding
    def draft_for(self, drafter, slots: List[int]) -> Dict[int, List[int]]:
        """Propose draft tokens for the given active slots from their
        prompt + emitted histories, clamped so that the accepted prefix
        plus the bonus token never steps past the request's token budget,
        the context wall or the slot's reserved pages (so every real
        window write stays inside pages the slot holds)."""
        hists = [list(self.active[i].prompt) + list(self.active[i].out)
                 for i in slots]
        t0 = time.perf_counter()
        proposals = drafter.propose(hists)
        self.draft_seconds += time.perf_counter() - t0
        drafts: Dict[int, List[int]] = {}
        for i, ks in zip(slots, proposals):
            r = self.active[i]
            cap = min(len(r.prompt) + r.max_new, self.max_len,
                      len(self.slot_pages[i]) * self.page)
            k = max(0, min(len(ks), drafter.max_draft,
                           cap - int(self.lengths[i]) - 1,
                           r.max_new - len(r.out) - 1))
            drafts[i] = [int(t) for t in ks[:k]]
        return drafts

    def verify_step(self, tokens: np.ndarray, view=None) -> np.ndarray:
        """One batched verify forward: every slot scores a fixed-width
        window ``[last_emitted, d1..d_{W-1}]`` from its own length through
        the ragged prefill attention (mid-page starts are legal).  Returns
        the greedy argmax at every window row, (slots, W): row t is the
        target's prediction for the token after position ``lengths + t``.
        The forward writes all W candidates' K/V into the pools; the host
        rolls a rejected suffix back by never advancing ``lengths`` over
        it."""
        if self.mesh is not None:
            raise ValueError("speculative verify has no sharded twin: "
                             "serve a mesh without a drafter")
        lengths, table = view if view is not None \
            else (self.lengths, self.table)
        t0 = time.perf_counter()
        logits = self.model.verify_step_paged(
            self.params, self.cache, self._dev(tokens), self._dev(lengths),
            self._dev(table))
        preds = torch.argmax(logits, dim=-1).cpu().numpy()
        self.verify_steps += 1
        self.verify_seconds += time.perf_counter() - t0
        return preds

    def note_spec(self, drafted: int, accepted: int, emitted: int) -> None:
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self.spec_emitted += emitted

    def verify_slots(self, cur: np.ndarray, slots: List[int],
                     drafts: Dict[int, List[int]], width: int) -> np.ndarray:
        """One batched fixed-width verify of ``slots``: their rows carry
        [current token, drafts..., padding]; every other slot rides along
        at length 0 on the trash page.  The caller runs
        :meth:`prepare_verify` first.  Returns (slots, width)
        predictions."""
        toks = np.zeros((self.slots, width), np.int32)
        mask = np.zeros((self.slots,), bool)
        for i in slots:
            mask[i] = True
            toks[i, 0] = cur[i]
            ks = drafts.get(i, [])
            toks[i, 1:1 + len(ks)] = ks
        return self.verify_step(
            toks, view=(np.where(mask, self.lengths, 0).astype(np.int32),
                        np.where(mask[:, None], self.table, 0
                                 ).astype(np.int32)))

    def accept(self, i: int, drafts: List[int], preds: np.ndarray,
               cur: np.ndarray) -> Tuple[int, int, bool]:
        """Longest-correct-prefix acceptance of slot ``i``'s verify window
        and host rollback: the emitted tokens advance ``lengths``, join the
        stream and ``cur``, with the decode path's finish checks after
        every token, so greedy streams (truncation points included) are
        the non-speculative ones.  Returns (accepted, emitted, finished)
        and counts them (``note_spec``)."""
        r = self.active[i]
        emit = accept_longest_prefix(drafts, preds)
        emitted, finished = 0, False
        for tok in emit:
            self.lengths[i] += 1
            r.out.append(tok)
            cur[i] = tok
            emitted += 1
            if len(r.out) >= r.max_new \
                    or int(self.lengths[i]) >= self.max_len:
                finished = True
                break
        self.note_spec(len(drafts), len(emit) - 1, emitted)
        return len(emit) - 1, emitted, finished

    def _admit_static(self, queue: List[Request], cur: np.ndarray,
                      done: List[Request]) -> None:
        """Static-schedule admission into every free slot, in slot order:
        reject permanently oversized requests up front (they must not
        head-of-line-block servable traffic), then admit while pages
        last.  A max_new == 1 request finishes right out of prefill and
        frees its slot for the next in line."""
        for i in range(self.slots):
            while self.active[i] is None and queue:
                while queue and not self.admissible(queue[0]):
                    r = queue.pop(0)
                    r.done = False
                    self.rejected += 1
                    self.rejected_requests.append(r)
                    self.log(f"[paged] rejecting request {r.rid}: "
                             f"{self._reject_reason(r)}")
                if not queue or not self.try_admit(queue[0], i):
                    return                     # wait for free pages
                r = queue.pop(0)
                cur[i] = r.out[-1]
                if len(r.out) >= r.max_new:    # max_new == 1 edge
                    r.done = True
                    done.append(r)
                    self._recycle(i)

    def _finish_or_reclaim(self, i: int, finished: bool,
                           done: List[Request]) -> None:
        r = self.active[i]
        if not finished:
            self._reclaim_slot(i)
            return
        r.done = True
        r.truncated = len(r.out) < r.max_new
        if r.truncated:
            self.truncated += 1
            self.log(f"[paged] truncating request {r.rid} at "
                     f"max_len={self.max_len} "
                     f"({len(r.out)}/{r.max_new} tokens)")
        done.append(r)
        self._recycle(i)

    def _resume(self) -> np.ndarray:
        cur = np.zeros((self.slots,), np.int32)
        for i, r in enumerate(self.active):    # resume pre-admitted slots
            if r is not None:
                cur[i] = r.out[-1]
        return cur

    def _idle(self, queue: List[Request]) -> bool:
        if any(r is not None for r in self.active):
            return False
        if queue:
            # unreachable by construction (an idle scheduler has every
            # page free, so only inadmissible requests can fail, and those
            # were rejected above) -- defensive
            raise RuntimeError("admission deadlock: empty batch but queued "
                               "requests cannot reserve pages")
        return True

    def run_speculative(self, requests: List[Request], drafter,
                        metrics=None) -> List[Request]:
        """Static-schedule speculative decoding: :meth:`run` with each
        decode round replaced by draft -> one fixed-width batched verify
        -> longest-correct-prefix acceptance -> host rollback.  Token
        emission repeats :meth:`run`'s finish checks after every token, so
        greedy streams, truncation points included, are the
        non-speculative ones."""
        width = drafter.max_draft + 1
        queue = list(requests)
        cur = self._resume()
        done: List[Request] = []
        while queue or any(r is not None for r in self.active):
            self._admit_static(queue, cur, done)
            if self._idle(queue):
                break
            slots = [i for i, r in enumerate(self.active) if r is not None]
            drafts = self.draft_for(drafter, slots)
            self.prepare_verify(slots, width)
            preds = self.verify_slots(cur, slots, drafts, width)
            for i in slots:
                accepted, emitted, finished = self.accept(i, drafts[i],
                                                          preds[i], cur)
                if metrics is not None:
                    metrics.on_spec_step(len(drafts[i]), accepted, emitted)
                self._finish_or_reclaim(i, finished, done)
        return done

    def run(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        cur = self._resume()
        done: List[Request] = []
        while queue or any(r is not None for r in self.active):
            self._admit_static(queue, cur, done)
            if self._idle(queue):
                break
            self.prepare_decode([i for i, r in enumerate(self.active)
                                 if r is not None])
            nxt = self.step(cur)
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                self.lengths[i] += 1
                r.out.append(int(nxt[i]))
                cur[i] = nxt[i]
                self._finish_or_reclaim(
                    i, len(r.out) >= r.max_new
                    or int(self.lengths[i]) >= self.max_len, done)
        return done


def main(argv=None) -> Dict:
    """Serve a seeded request stream; returns a report dict (the finished
    requests, token and time totals, TTFT percentiles, dispatch routes,
    and the dense, prefix and speculative counters)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--cache", default="dense", choices=("dense", "paged"),
                    help="KV-cache layout: a dense rectangle (prompts "
                         "teacher-forced through decode at one shared "
                         "position) or the paged pool")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged layout page size; 0 = pick from the tuned "
                         "decode plans (fallback %d)" % DEFAULT_PAGE_SIZE)
    ap.add_argument("--total-pages", type=int, default=0,
                    help="page-pool size; 0 = full capacity "
                         "(slots x max_len); smaller oversubscribes")
    ap.add_argument("--kv-dtype", default="",
                    choices=("", "fp32", "bf16", "int8"),
                    help="paged KV pool storage dtype ('' = model compute "
                         "dtype); int8 stores symmetric-quantized pages with "
                         "per-(page, kv-head) fp32 scales that the "
                         "attention kernels dequantize at tile load")
    ap.add_argument("--weights-dtype", default="", choices=("", "int8"),
                    help="projection/MLP weight GEMMs: int8 quantizes each "
                         "weight per output channel once and routes through "
                         "dispatch.quantized_matmul (fp32 accumulate)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="share KV pages across requests with common prompt "
                         "prefixes (refcounted pages, copy-on-write "
                         "appends, prefill skipping)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="loadgen: length of the common prompt prefix "
                         "sharing requests start with")
    ap.add_argument("--shared-frac", type=float, default=0.0,
                    help="loadgen: fraction of requests that carry the "
                         "shared prefix (0..1)")
    ap.add_argument("--schedule", default="static",
                    choices=("static", "continuous"),
                    help="static run-to-completion or continuous batching "
                         "on a virtual arrival clock (paged)")
    ap.add_argument("--speculate", default="", choices=("", "ngram", "model"),
                    help="paged: speculative decoding drafter -- 'ngram' "
                         "(suffix matching over the emitted tokens) or "
                         "'model' (the target's leading layers as a draft "
                         "model); drafts are verified in one fixed-width "
                         "batched forward through the ragged prefill "
                         "attention and rejected suffixes rolled back on "
                         "the host")
    ap.add_argument("--draft-tokens", type=int, default=3,
                    help="speculative: max draft tokens per verify window "
                         "(window width = draft_tokens + 1)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="continuous: max tokens composed per iteration "
                         "(0 = slots x page_size)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="continuous: Poisson arrival rate in requests "
                         "per clock unit (0 = burst at t=0)")
    ap.add_argument("--clock", default="wall", choices=("wall", "tick"),
                    help="continuous: virtual clock advances by measured "
                         "step wall time or a fixed tick")
    ap.add_argument("--tick", type=float, default=1.0,
                    help="continuous: clock increment per iteration in "
                         "tick mode")
    ap.add_argument("--seed", type=int, default=0,
                    help="load-generator seed (arrivals + prompt tokens)")
    ap.add_argument("--mesh", type=int, default=0,
                    help="tensor-parallel degree: shard attention heads "
                         "and KV page pools over an N-rank ('model',) "
                         "mesh (launch/mesh.make_serving_mesh). 0 = "
                         "unsharded; 1 = degenerate mesh (bit-identical "
                         "streams); N >= 2 needs N ranks "
                         "(torchrun --nproc-per-node N)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.speculate and args.cache != "paged":
        raise SystemExit("--speculate requires --cache paged")
    if args.schedule == "continuous" and args.cache != "paged":
        raise SystemExit("--schedule continuous requires --cache paged")
    mesh = None
    say = print
    if args.mesh:
        if args.cache != "paged":
            raise SystemExit("--mesh requires --cache paged")
        if args.speculate:
            raise SystemExit("--speculate is not supported with --mesh "
                             "(no sharded verify twin yet)")
        from .mesh import make_serving_mesh
        mesh = make_serving_mesh(args.mesh, device=args.device)
        if mesh.rank:     # only rank 0 prints the report
            say = _silent
        say(f"[mesh] model={args.mesh} ranks={mesh.size} "
            f"backend={mesh.backend} device={mesh.device}")

    from ..tune.cache import preload as preload_tuned
    preload_tuned(log=say)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, kv_cache=args.cache,
                              kv_page_size=args.page_size,
                              kv_dtype=args.kv_dtype,
                              weights_dtype=args.weights_dtype)
    if cfg.input_mode == "embeddings":
        raise SystemExit("serving demo drives token-mode archs")
    model = Model(cfg, dt=DtypePolicy(param=torch.bfloat16),
                  device=mesh.device if mesh is not None else args.device)
    # a mesh draws the whole model on each rank and keeps its shards (in
    # PagedScheduler, below)
    params = model.init(seed=0) if mesh is None else None
    drafter = None
    if args.speculate:
        # the model drafter is the target's leading layers (early-exit
        # drafting), which is what buys real acceptance
        drafter = make_drafter(args.speculate, cfg,
                               max_draft=args.draft_tokens, target=model,
                               target_params=params,
                               pad_to=args.max_len + args.draft_tokens,
                               batch_pad=args.slots)
        print(f"[spec] drafter={args.speculate} "
              f"draft_tokens={args.draft_tokens}")
    if args.cache == "paged":
        # ranks sharing a card build their shards in turn: each holds the
        # whole model (drawn in fp32, a stack at a time) only while it
        # shards it
        from .mesh import in_turn
        for _ in in_turn(mesh):
            server = PagedScheduler(model, params if mesh is None
                                    else model.init(seed=0),
                                    slots=args.slots, max_len=args.max_len,
                                    page_size=args.page_size,
                                    total_pages=args.total_pages,
                                    prefix_cache=args.prefix_cache,
                                    mesh=mesh, log=say)
        say(f"[paged] arch={cfg.name} device={model.device} "
            f"page_size={server.page} pool={server.alloc.total} pages "
            f"({server.n_slot_pages}/slot max, "
            f"kv_dtype={args.kv_dtype or 'compute'}, "
            f"weights_dtype={args.weights_dtype or 'compute'}, "
            f"page_bytes={server._page_bytes}, "
            f"prefix_cache={'on' if args.prefix_cache else 'off'}, "
            f"tp={server.tp})")
    else:
        server = Server(model, params, slots=args.slots,
                        max_len=args.max_len)
        print(f"[dense] arch={cfg.name} device={model.device} "
              f"slots={args.slots} max_len={args.max_len} "
              f"weights_dtype={args.weights_dtype or 'compute'}")
    # static requests are the rate-0 stream, so both schedules serve one
    # list (without a shared prefix these are the prompts the JAX
    # package's static path draws)
    reqs = poisson_stream(args.requests,
                          rate=args.rate if args.schedule == "continuous"
                          else 0.0,
                          vocab_size=cfg.vocab_size,
                          prompt_len=args.prompt_len, max_new=args.max_new,
                          seed=args.seed,
                          shared_prefix_len=args.shared_prefix_len,
                          shared_frac=args.shared_frac)
    dispatch.reset_stats()
    summary: Dict = {}
    phases: Dict = {}
    max_kv_bytes = None
    if args.schedule == "continuous":
        from .engine import ContinuousEngine
        engine = ContinuousEngine(server, token_budget=args.token_budget,
                                  clock=args.clock, tick=args.tick,
                                  drafter=drafter, log=say)
        engine.warmup()
        t0 = time.time()
        done = engine.run(reqs)      # ends in a host read of the tokens
        dt = time.time() - t0
        summary = engine.metrics.summary()
        max_kv_bytes = engine.max_resident_kv_bytes
        ex = engine.executor
        phases = {"prefill_calls": ex.prefill_calls,
                  "prefill_seconds": ex.t_prefill,
                  "decode_steps": server.decode_steps,
                  "decode_seconds": ex.t_decode}
        say(f"[engine] iterations={engine.iterations} "
            f"prefill_calls={ex.prefill_calls} "
            f"max_prefill_batch={ex.max_prefill_batch} "
            f"rejected={server.rejected}")
    else:
        t0 = time.time()
        if drafter is not None:
            done = server.run_speculative(reqs, drafter)
        else:
            done = server.run(reqs)
        dt = time.time() - t0
        if args.cache == "dense":
            phases = {"decode_steps": server.decode_steps,
                      "decode_seconds": server.decode_seconds}
    if mesh is not None and mesh.size > 1:
        # every rank must have reached the same greedy tokens
        mine = sorted((r.rid, list(r.out)) for r in done)
        ranks = mesh.group("model").all_gather_object(mine)
        if any(other != mine for other in ranks):
            raise AssertionError(f"rank {mesh.rank}: the ranks' streams "
                                 f"differ: {ranks}")
    total_new = sum(len(r.out) for r in done)
    say(f"served {len(done)} requests, {total_new} new tokens in "
        f"{dt:.2f}s ({total_new / dt:.1f} tok/s, {args.slots} slots, "
        f"cache={args.cache}, schedule={args.schedule})")
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
    say(f"[serve] ttft p50={fmt(summary.get('ttft_p50'))} "
        f"p99={fmt(summary.get('ttft_p99'))}  tok_latency "
        f"p50={fmt(summary.get('tok_latency_p50'))} "
        f"p99={fmt(summary.get('tok_latency_p99'))} "
        f"({args.clock if args.schedule == 'continuous' else 'n/a'} clock)")
    dense = spec = prefix = None
    if args.cache == "dense":
        dense = {"truncated": server.truncated, "rejected": server.rejected,
                 "pos": server.pos}
        if server.truncated or server.rejected:
            say(f"[dense] truncated={server.truncated} "
                f"rejected={server.rejected}")
    else:
        if server.window:
            say(f"[paged] reclaimed {server.pages_reclaimed} window-dead "
                f"page(s) (window={server.window})")
        if server.truncated or server.rejected:
            say(f"[paged] truncated={server.truncated} "
                f"rejected={server.rejected}")
        if server.prefix is not None:
            prefix = {"hits": server.prefix.hits,
                      "misses": server.prefix.misses,
                      "shared_tokens": server.shared_tokens_total,
                      "cow_copies": server.cow_copies,
                      "evictions": server.prefix.evictions,
                      "cached_pages": server.prefix.n_pages()}
            say("[prefix] " + " ".join(f"{k}={v}"
                                       for k, v in prefix.items()))
    if drafter is not None and server.verify_steps:
        spec = {"verify_steps": server.verify_steps,
                "drafted": server.spec_drafted,
                "accepted": server.spec_accepted,
                "emitted": server.spec_emitted,
                "accept_rate": (server.spec_accepted / server.spec_drafted
                                if server.spec_drafted else 0.0),
                "tokens_per_step": server.spec_emitted / server.verify_steps,
                "verify_seconds": server.verify_seconds,
                "draft_seconds": server.draft_seconds}
        say(f"[spec] verify_steps={spec['verify_steps']} "
            f"drafted={spec['drafted']} accepted={spec['accepted']} "
            f"accept_rate={spec['accept_rate']:.3f} "
            f"emitted={spec['emitted']} "
            f"tokens_per_step={spec['tokens_per_step']:.2f}")
    if max_kv_bytes is not None:
        say(f"[paged] max_resident_kv_bytes={max_kv_bytes}")
    routes = dispatch.stats()
    for (op, route), n in sorted(routes.items()):
        say(f"[dispatch] {op:>22s} -> {route:<6s} x{n}")
    return {"done": done, "new_tokens": total_new, "seconds": dt,
            "tok_s": total_new / dt, "ttft_p50": summary.get("ttft_p50"),
            "ttft_p99": summary.get("ttft_p99"), "routes": routes,
            "phases": phases, "prefix": prefix, "dense": dense,
            "spec": spec, "max_resident_kv_bytes": max_kv_bytes,
            "tp": server.tp if args.cache == "paged" else 0,
            "page_size": server.page if args.cache == "paged" else 0,
            "tp_routes": dispatch.tp_stats()}


if __name__ == "__main__":
    main()
