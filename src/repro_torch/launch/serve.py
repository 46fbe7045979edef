"""Paged-KV serving: the port of ``repro/launch/serve.py``.

The KV cache is a pool of fixed-size pages (paper §4.3 memory banking); a
host-side scheduler does admission control (a request is admitted only
when its whole lifetime's pages can be reserved), chunked prefill (the
ragged multi-token prefill kernel), batched decode over ragged lengths
(every slot at its own position, the ragged decode kernel), sliding-window
page reclamation and slot recycling.  The scheduler computes addresses
(page tables); the kernels only ever see dense tiles.

Two schedules (``--schedule {static,continuous}``):

* ``static`` -- ``PagedScheduler.run``: admit a static request list,
  whole-prompt prefill on admission, decode rounds to completion.
* ``continuous`` -- ``launch/engine.ContinuousEngine``: requests arrive
  on a virtual clock, each iteration composes multi-slot prefill chunks
  and decode steps under a token budget, and ``launch/metrics`` records
  TTFT and per-token latency percentiles.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --schedule continuous --requests 6 --prompt-len 100 --max-new 16 \\
      --max-len 256                 # on the CUDA card (the default)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --smoke --device cpu          # the plain PyTorch versions on the CPU
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs import get_arch
from ..core.memory import DtypePolicy
from ..kernels import dispatch
from ..models.transformer import Model, paged_supported
from .loadgen import Request, poisson_stream

DEFAULT_PAGE_SIZE = 64


class PageAllocator:
    """Host-side refcounted free list over the shared page pool.

    Physical page 0 is reserved as the TRASH page: inactive slots' tables
    point every logical page at it, so their masked decode writes can
    never corrupt a live sequence.  ``alloc`` hands pages out at refcount
    1 and ``release`` returns a page to the free list when its last holder
    lets go (sharing pages between requests comes with prefix caching).
    """

    def __init__(self, total_pages: int):
        self.total = total_pages
        self._free = list(range(total_pages - 1, 0, -1))
        self.ref = [0] * total_pages

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
        return got

    def release(self, pages: List[int]) -> None:
        for p in reversed(pages):
            assert self.ref[p] > 0, f"double free of page {p}"
            self.ref[p] -= 1
            if self.ref[p] == 0:
                self._free.append(p)


class PagedScheduler:
    """Admission, chunked prefill, batched ragged decode, slot recycling."""

    def __init__(self, model: Model, params, *, slots: int, max_len: int,
                 page_size: int = 0, total_pages: int = 0, log=print):
        if not paged_supported(model.cfg):
            raise ValueError(
                f"arch {model.cfg.name} has layers this port cannot serve "
                "from a paged cache (attention + MLP stacks only)")
        self.model = model
        self.params = params
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.log = log or (lambda *a, **k: None)
        self.page = page_size or model.cfg.kv_page_size or DEFAULT_PAGE_SIZE
        self.n_slot_pages = -(-max_len // self.page)
        total = total_pages or 1 + slots * self.n_slot_pages
        self.alloc = PageAllocator(total)
        self.cache = model.init_paged_cache(slots, max_len, self.page,
                                            total_pages=total)
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
        self.rejected = 0                 # inadmissible requests, counted
        self.rejected_requests: List[Request] = []
        self.truncated = 0                # finished early at max_len

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array as an int32 tensor on the model's device."""
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
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
        ``slot``.  Prefill is the caller's business."""
        need = self.pages_needed(r)
        if need > self.n_slot_pages or self.alloc.available() < need:
            return False
        pages = self.alloc.alloc(need)
        self.slot_pages[slot] = pages
        self.reclaimed[slot] = 0
        self.table[slot] = 0
        self.table[slot, :need] = pages
        self.lengths[slot] = 0
        self.active[slot] = r
        self.check_page_accounting()
        return True

    def try_admit(self, r: Request, slot: int) -> bool:
        """Static-schedule admission: reserve, then chunk-prefill the
        prompt to completion."""
        if not self.reserve(r, slot):
            return False
        first = self._prefill_prompt(r, slot)
        self.lengths[slot] = len(r.prompt)
        r.out.append(first)
        self._reclaim_slot(slot)    # long prompts can outrun the window
        return True

    def _prefill_prompt(self, r: Request, slot: int) -> int:
        """Chunked prefill, one page per forward; returns the first
        generated token from the last real prompt position's logits."""
        ln = len(r.prompt)
        padded = -(-ln // self.page) * self.page
        toks = np.zeros((padded,), np.int32)
        toks[:ln] = r.prompt
        table_row = self._dev(self.table[slot:slot + 1])
        logits = None
        for t0 in range(0, ln, self.page):
            last = min(ln, t0 + self.page) - 1 - t0
            logits = self.model.prefill_step_paged(
                self.params, self.cache, self._dev(toks[None, t0:t0 + self.page]),
                self._dev([t0]), table_row, self._dev([last]))
        self.prefill_tokens += ln
        return int(torch.argmax(logits[0]).item())

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

    def check_page_accounting(self) -> None:
        """Invariant: every page is free, held, or the trash page; the
        total reference count equals the live slot bindings; and every
        active slot's cursor sits inside its live binding."""
        held = self.alloc.held()
        free = self.alloc.available()
        assert held + free + 1 == self.alloc.total, (
            f"page accounting broken: held={held} free={free} "
            f"trash=1 != total={self.alloc.total}")
        expected = sum(len(p) - r for p, r in zip(self.slot_pages,
                                                  self.reclaimed))
        refs = sum(self.alloc.ref[1:])
        assert refs == expected, (
            f"refcount accounting broken: sum(ref)={refs} != slot "
            f"bindings {expected}")
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

    def _recycle(self, slot: int) -> None:
        self.alloc.release(self.slot_pages[slot][self.reclaimed[slot]:])
        self.slot_pages[slot] = []
        self.reclaimed[slot] = 0
        self.table[slot] = 0
        self.lengths[slot] = 0
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
        logits = self.model.decode_step(
            self.params, self.cache, self._dev(tokens)[:, None],
            paged=(self._dev(lengths), self._dev(table)))
        self.decode_steps += 1
        self.decode_tokens += int(np.count_nonzero(lengths))
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def run(self, requests: List[Request]) -> List[Request]:
        queue = list(requests)
        cur = np.zeros((self.slots,), np.int32)
        for i, r in enumerate(self.active):    # resume pre-admitted slots
            if r is not None:
                cur[i] = r.out[-1]
        done: List[Request] = []
        while queue or any(r is not None for r in self.active):
            blocked = False
            for i in range(self.slots):
                # `while`, not `if`: a max_new == 1 request finishes right
                # out of prefill and frees its slot for the next in line
                while self.active[i] is None and queue and not blocked:
                    # reject permanently-oversized requests up front (they
                    # must not head-of-line-block servable traffic)
                    while queue and not self.admissible(queue[0]):
                        r = queue.pop(0)
                        r.done = False
                        self.rejected += 1
                        self.rejected_requests.append(r)
                        self.log(f"[paged] rejecting request {r.rid}: "
                                 f"{self._reject_reason(r)}")
                    if not queue or not self.try_admit(queue[0], i):
                        blocked = True             # wait for free pages
                        break
                    r = queue.pop(0)
                    cur[i] = r.out[-1]
                    if len(r.out) >= r.max_new:    # max_new == 1 edge
                        r.done = True
                        done.append(r)
                        self._recycle(i)
                if blocked:
                    break
            if not any(r is not None for r in self.active):
                if queue:
                    # unreachable by construction (an idle scheduler has
                    # every page free, so only inadmissible requests can
                    # fail, and those were rejected above) -- defensive
                    raise RuntimeError(
                        "admission deadlock: empty batch but queued "
                        "requests cannot reserve pages")
                break
            nxt = self.step(cur)
            for i, r in enumerate(self.active):
                if r is None:
                    continue
                self.lengths[i] += 1
                r.out.append(int(nxt[i]))
                cur[i] = nxt[i]
                if len(r.out) >= r.max_new \
                        or int(self.lengths[i]) >= self.max_len:
                    r.done = True
                    r.truncated = len(r.out) < r.max_new
                    if r.truncated:
                        self.truncated += 1
                        self.log(f"[paged] truncating request {r.rid} at "
                                 f"max_len={self.max_len} "
                                 f"({len(r.out)}/{r.max_new} tokens)")
                    done.append(r)
                    self._recycle(i)
                else:
                    self._reclaim_slot(i)
        return done


def main(argv=None) -> Dict:
    """Serve a seeded request stream; returns a report dict (the finished
    requests, token and time totals, TTFT percentiles, dispatch routes)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=DEFAULT_PAGE_SIZE)
    ap.add_argument("--total-pages", type=int, default=0,
                    help="page-pool size; 0 = full capacity "
                         "(slots x max_len); smaller oversubscribes")
    ap.add_argument("--schedule", default="static",
                    choices=("static", "continuous"),
                    help="static run-to-completion or continuous batching "
                         "on a virtual arrival clock")
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
    ap.add_argument("--device", default="cuda",
                    help="cuda (the hand-written kernels) or cpu (their "
                         "plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    cfg = dataclasses.replace(cfg, kv_cache="paged",
                              kv_page_size=args.page_size)
    model = Model(cfg, dt=DtypePolicy(param=torch.bfloat16),
                  device=args.device)
    params = model.init(seed=0)
    server = PagedScheduler(model, params, slots=args.slots,
                            max_len=args.max_len, page_size=args.page_size,
                            total_pages=args.total_pages)
    print(f"[paged] arch={cfg.name} device={model.device} "
          f"page_size={server.page} pool={server.alloc.total} pages "
          f"({server.n_slot_pages}/slot max)")
    # static requests are the rate-0 stream: the same seeded prompts the
    # JAX package's static path draws, so both schedules serve one list
    reqs = poisson_stream(args.requests,
                          rate=args.rate if args.schedule == "continuous"
                          else 0.0,
                          vocab_size=cfg.vocab_size,
                          prompt_len=args.prompt_len, max_new=args.max_new,
                          seed=args.seed)
    dispatch.reset_stats()
    summary: Dict = {}
    phases: Dict = {}
    if args.schedule == "continuous":
        from .engine import ContinuousEngine
        engine = ContinuousEngine(server, token_budget=args.token_budget,
                                  clock=args.clock, tick=args.tick)
        engine.warmup()
        t0 = time.time()
        done = engine.run(reqs)      # ends in a host read of the tokens
        dt = time.time() - t0
        summary = engine.metrics.summary()
        ex = engine.executor
        phases = {"prefill_calls": ex.prefill_calls,
                  "prefill_seconds": ex.t_prefill,
                  "decode_steps": server.decode_steps,
                  "decode_seconds": ex.t_decode}
        print(f"[engine] iterations={engine.iterations} "
              f"prefill_calls={ex.prefill_calls} "
              f"max_prefill_batch={ex.max_prefill_batch} "
              f"rejected={server.rejected}")
    else:
        t0 = time.time()
        done = server.run(reqs)
        dt = time.time() - t0
    total_new = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_new} new tokens in "
          f"{dt:.2f}s ({total_new / dt:.1f} tok/s, {args.slots} slots, "
          f"schedule={args.schedule})")
    fmt = lambda v: "n/a" if v is None else f"{v:.4f}"  # noqa: E731
    print(f"[serve] ttft p50={fmt(summary.get('ttft_p50'))} "
          f"p99={fmt(summary.get('ttft_p99'))}  tok_latency "
          f"p50={fmt(summary.get('tok_latency_p50'))} "
          f"p99={fmt(summary.get('tok_latency_p99'))} "
          f"({args.clock if args.schedule == 'continuous' else 'n/a'} clock)")
    if server.window:
        print(f"[paged] reclaimed {server.pages_reclaimed} window-dead "
              f"page(s) (window={server.window})")
    if server.truncated or server.rejected:
        print(f"[paged] truncated={server.truncated} "
              f"rejected={server.rejected}")
    routes = dispatch.stats()
    for (op, route), n in sorted(routes.items()):
        print(f"[dispatch] {op:>17s} -> {route:<6s} x{n}")
    return {"done": done, "new_tokens": total_new, "seconds": dt,
            "tok_s": total_new / dt, "ttft_p50": summary.get("ttft_p50"),
            "ttft_p99": summary.get("ttft_p99"), "routes": routes,
            "phases": phases}


if __name__ == "__main__":
    main()
