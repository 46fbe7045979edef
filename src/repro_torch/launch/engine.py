"""Continuous-batching serving engine: the port of ``repro/launch/engine.py``.

The layered decomposition of serving, shaped like the paper's dataflow
discipline (concurrently executing stages connected by explicit state):

* **load generation** (``launch/loadgen.py``) -- timed request streams on
  a virtual clock;
* **admission / resources** (``launch/serve.PagedScheduler``) -- page
  reservation, prefix sharing (a fully-covered prompt skips prefill and
  goes straight to decode), tables, reclamation, recycling;
* **batch composition** (:class:`BatchPolicy`) -- each iteration picks
  page-sized prefill chunks from MULTIPLE waiting slots and decode steps
  for running slots under a per-iteration token budget;
* **step execution** (:class:`StepExecutor`) -- ONE multi-slot prefill
  forward (B = number of chunks) plus ONE batched ragged decode whose view
  masks non-decoding slots to the trash page; with a drafter, one batched
  fixed-width verify forward in place of the decode
  (``launch/speculative.py``);
* **metrics** (``launch/metrics.py``) -- per-request TTFT and per-token
  latency on the same clock.

``clock="wall"`` advances the clock by measured step time; ``clock="tick"``
by a fixed tick (deterministic tests and seeded load replay).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .loadgen import ArrivalQueue, Request
from .metrics import ServeMetrics


@dataclass
class StepPlan:
    """One engine iteration's work: ``prefill`` holds (slot, chunk start)
    pairs batched through ONE prefill forward; ``decode`` the slots that
    take a decode token; ``verify`` the draft tokens (per decode slot)
    that speculative mode admitted under the token budget, riding the
    same batched forward as the decode token they extend."""
    prefill: List[Tuple[int, int]] = field(default_factory=list)
    decode: List[int] = field(default_factory=list)
    verify: Dict[int, List[int]] = field(default_factory=dict)

    def empty(self) -> bool:
        return not self.prefill and not self.decode


@dataclass
class _PrefillState:
    """A slot's in-flight chunked prefill: page-padded prompt tokens, the
    true prompt length, the next chunk's offset, and how many leading
    tokens a prefix-cache hit let it skip."""
    toks: np.ndarray
    ln: int
    pos: int = 0
    skipped: int = 0


class BatchPolicy:
    """Decode-first token-budget batch composition.

    Every running slot gets its decode token first; the remaining budget
    admits page-sized prefill chunks from distinct mid-prefill slots (at
    most one chunk per slot per iteration: chunk n+1 attends to chunk n's
    pages).  A budget smaller than one page still forces a chunk through
    when nothing is decoding, so admission can never livelock.  The
    running decode set is never trimmed to fit the budget: when decodes
    alone meet or exceed it, the prefill allowance clamps to zero.
    """

    def __init__(self, token_budget: int, page: int):
        self.token_budget = int(token_budget)
        self.page = int(page)

    def compose(self, running: List[int],
                prefilling: List[Tuple[int, int]],
                drafts: Optional[Dict[int, List[int]]] = None) -> StepPlan:
        """``drafts`` (speculative mode) maps running slots to proposed
        draft tokens; they are admitted after the decode tokens and before
        prefill chunks, under the same budget, so leftover budget still
        prefills."""
        decode = list(running)
        left = max(0, self.token_budget - len(decode))
        verify: Dict[int, List[int]] = {}
        if drafts:
            for slot in decode:
                ks = drafts.get(slot, [])
                take = min(len(ks), left)
                if take > 0:
                    verify[slot] = list(ks[:take])
                    left -= take
        chunks: List[Tuple[int, int]] = []
        for slot, start in prefilling:
            if left < self.page:
                break
            chunks.append((slot, start))
            left -= self.page
        if not decode and not chunks and prefilling:
            chunks.append(prefilling[0])   # forced progress
        return StepPlan(prefill=chunks, decode=decode, verify=verify)


class StepExecutor:
    """Issues a composed :class:`StepPlan` through the scheduler's paged
    forwards, accumulating per-phase wall time and the multi-slot
    batch-width stats."""

    def __init__(self, sched):
        self.sched = sched
        self.t_prefill = 0.0
        self.t_decode = 0.0
        self.prefill_calls = 0
        self.prefill_chunks = 0
        self.max_prefill_batch = 0

    def prefill(self, chunks: List[Tuple[int, int]],
                states: List[Optional[_PrefillState]]) -> np.ndarray:
        """One batched multi-slot prefill forward (B = len(chunks)).
        Returns (B,) greedy tokens; row i is chunk i's last real
        position's argmax."""
        sched = self.sched
        page = sched.page
        toks = np.stack([states[s].toks[st:st + page] for s, st in chunks])
        starts = np.asarray([st for _, st in chunks], np.int32)
        tables = sched.table[[s for s, _ in chunks]]
        last = np.asarray([min(states[s].ln, st + page) - 1 - st
                           for s, st in chunks], np.int32)
        t0 = time.perf_counter()
        logits = sched.prefill_forward(sched._dev(toks), sched._dev(starts),
                                       sched._dev(tables), sched._dev(last))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.t_prefill += time.perf_counter() - t0
        self.prefill_calls += 1
        self.prefill_chunks += len(chunks)
        self.max_prefill_batch = max(self.max_prefill_batch, len(chunks))
        return nxt

    def decode(self, cur: np.ndarray, decode_slots: List[int]) -> np.ndarray:
        """One batched ragged decode.  Non-decoding slots (mid-prefill or
        idle) ride along with a zero length and an all-trash table view,
        so their masked writes can never touch a live page."""
        sched = self.sched
        sched.prepare_decode(decode_slots)   # copy-on-write sweep first
        mask = np.zeros((sched.slots,), bool)
        mask[decode_slots] = True
        lengths = np.where(mask, sched.lengths, 0).astype(np.int32)
        table = np.where(mask[:, None], sched.table, 0).astype(np.int32)
        t0 = time.perf_counter()
        nxt = sched.step(cur, view=(lengths, table))
        self.t_decode += time.perf_counter() - t0
        return nxt

    def verify(self, cur: np.ndarray, decode_slots: List[int],
               drafts: Dict[int, List[int]], width: int) -> np.ndarray:
        """One batched fixed-width verify forward in place of the decode
        step: slot rows carry [current token, drafts..., padding];
        non-decoding slots ride along masked to the trash page as in
        :meth:`decode`.  Returns (slots, width) greedy predictions."""
        sched = self.sched
        sched.prepare_verify(decode_slots, width)  # full-span CoW sweep
        t0 = time.perf_counter()
        preds = sched.verify_slots(cur, decode_slots, drafts, width)
        self.t_decode += time.perf_counter() - t0
        return preds


class ContinuousEngine:
    """Admission -> compose -> execute -> account, once per iteration.

    Requests arrive on the virtual clock via an :class:`ArrivalQueue`;
    waiting requests admit FCFS into free slots by reserving their whole
    lifetime's pages up front, then prefill chunk by chunk ACROSS
    iterations -- so one long prompt never stalls the decode cadence of
    running slots, and mid-prefill slots share one batched prefill.
    """

    def __init__(self, sched, *, token_budget: int = 0,
                 clock: str = "wall", tick: float = 1.0,
                 metrics: Optional[ServeMetrics] = None, drafter=None,
                 log=print):
        if clock not in ("wall", "tick"):
            raise ValueError(f"clock must be wall|tick, got {clock!r}")
        self.sched = sched
        self.policy = BatchPolicy(token_budget or sched.slots * sched.page,
                                  sched.page)
        self.executor = StepExecutor(sched)
        # speculative mode: a drafter swaps the decode step for a
        # fixed-width draft / verify / rollback step
        self.drafter = drafter
        self.verify_width = (drafter.max_draft + 1) if drafter else 0
        self.clock_mode = clock
        self.tick = float(tick)
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.log = log or (lambda *a, **k: None)
        self.clock = 0.0
        self.queue: Optional[ArrivalQueue] = None
        self.waiting: List[Request] = []
        self.states: List[Optional[_PrefillState]] = [None] * sched.slots
        self.cur = np.zeros((sched.slots,), np.int32)
        self.done: List[Request] = []
        self.admission_order: List[int] = []
        self.iterations = 0
        self.max_resident = 0
        # peak bytes of live KV pool (pages x per-page bytes at the storage
        # dtype, scales included): comparable across kv dtypes
        self.max_resident_kv_bytes = 0

    # ------------------------------------------------------------- warmup
    def warmup(self) -> None:
        """Run every prefill batch width (1..slots), the masked decode
        step and, with a drafter, the masked verify step once outside the
        timed region (the kernel library loads on first use); all warmup
        writes land on the trash page, so live state is untouched."""
        sched = self.sched
        if sched.tp > 1:
            self.log(f"[engine] warmup on a tp={sched.tp} mesh "
                     f"(sharded decode/prefill steps)")
        for b in range(1, sched.slots + 1):
            sched.prefill_forward(
                sched._dev(np.zeros((b, sched.page))),
                sched._dev(np.zeros((b,))),
                sched._dev(np.zeros((b, sched.n_slot_pages))),
                sched._dev(np.full((b,), sched.page - 1)))
        zeros = np.zeros((sched.slots,), np.int32)
        sched.step(zeros, view=(zeros, np.zeros_like(sched.table)))
        if self.drafter is not None:
            sched.verify_step(
                np.zeros((sched.slots, self.verify_width), np.int32),
                view=(zeros, np.zeros_like(sched.table)))
            sched.verify_steps = 0
            sched.verify_seconds = 0.0
        sched.decode_steps = 0
        sched.decode_tokens = 0

    # ---------------------------------------------------------- admission
    def _admit(self, now: float) -> None:
        sched = self.sched
        keep: List[Request] = []
        for r in self.waiting:
            if sched.admissible(r):
                keep.append(r)
                continue
            r.done = False
            sched.rejected += 1
            sched.rejected_requests.append(r)
            self.metrics.on_reject(r.rid, now)
            self.log(f"[engine] rejecting request {r.rid}: "
                     f"{sched._reject_reason(r)}")
        self.waiting = keep
        for slot in range(sched.slots):
            if not self.waiting:
                break
            if sched.active[slot] is not None:
                continue
            if not sched.reserve(self.waiting[0], slot):
                break                      # FCFS: never bypass the head
            r = self.waiting.pop(0)
            ln = len(r.prompt)
            shared = int(sched.shared_tokens[slot])
            if shared >= ln:
                # fully covered by the prefix cache: no prefill forward at
                # all; the slot goes straight to running with lengths =
                # ln - 1 and the last prompt token teacher-forced through
                # the next batched decode, whose append copy-on-writes the
                # shared page it lands in (reserve stashed the spare page)
                sched.lengths[slot] = ln - 1
                self.cur[slot] = int(r.prompt[ln - 1])
                self.states[slot] = None
            else:
                # partial coverage is page-aligned (the trie matches whole
                # chunks): prefill resumes at the first uncovered chunk
                toks = np.zeros((-(-ln // sched.page) * sched.page,),
                                np.int32)
                toks[:ln] = r.prompt
                self.states[slot] = _PrefillState(toks, ln, pos=shared,
                                                  skipped=shared)
            self.admission_order.append(r.rid)
            self.metrics.on_admit(r.rid, now)

    def _maybe_truncate(self, r: Request, slot: int) -> None:
        """A request stopped by the context wall rather than its own
        ``max_new`` is truncated -- flagged, counted, logged."""
        r.truncated = len(r.out) < r.max_new
        if r.truncated:
            self.sched.truncated += 1
            self.metrics.on_truncate(r.rid)
            self.log(f"[engine] truncating request {r.rid} at the context "
                     f"wall: {len(r.out)}/{r.max_new} tokens "
                     f"(max_len={self.sched.max_len})")

    def _finish(self, slot: int, t: float) -> None:
        r = self.sched.active[slot]
        r.done = True
        self.done.append(r)
        self.metrics.on_finish(r.rid, t)
        self.sched._recycle(slot)
        self.states[slot] = None

    # ------------------------------------------------------ one iteration
    def step(self) -> bool:
        """One engine iteration; returns False once fully drained."""
        sched = self.sched
        now = self.clock
        if self.queue is not None:
            for r in self.queue.pop_ready(now):
                self.metrics.on_arrival(r.rid, r.arrival)
                self.waiting.append(r)
        self._admit(now)
        self.max_resident = max(
            self.max_resident,
            sum(1 for a in sched.active if a is not None))
        self.max_resident_kv_bytes = max(
            self.max_resident_kv_bytes, sched.kv_bytes_resident())

        running = [i for i in range(sched.slots)
                   if sched.active[i] is not None and self.states[i] is None]
        prefilling = [(i, self.states[i].pos) for i in range(sched.slots)
                      if self.states[i] is not None]
        drafts = (sched.draft_for(self.drafter, running)
                  if self.drafter is not None and running else None)
        plan = self.policy.compose(running, prefilling, drafts=drafts)

        if plan.empty():
            nxt = (self.queue.next_arrival()
                   if self.queue is not None else None)
            if nxt is not None:
                self.clock = max(self.clock, nxt)   # idle: jump forward
                return True
            if self.waiting:
                # unreachable by construction (an idle engine has every
                # page free, so only inadmissible requests can fail, and
                # those were rejected above) -- defensive
                raise RuntimeError(
                    "admission deadlock: empty batch but queued requests "
                    "cannot reserve pages")
            return False

        t0 = time.perf_counter()
        first_toks = (self.executor.prefill(plan.prefill, self.states)
                      if plan.prefill else None)
        speculative = self.drafter is not None
        nxt_tok = preds = None
        if plan.decode:
            if speculative:
                preds = self.executor.verify(self.cur, plan.decode,
                                             plan.verify, self.verify_width)
            else:
                nxt_tok = self.executor.decode(self.cur, plan.decode)
        # under a mesh every rank takes rank 0's step time, so all ranks
        # admit on the same iterations (the JAX package has one process
        # and one clock)
        self.clock += (sched.step_seconds(time.perf_counter() - t0)
                       if self.clock_mode == "wall" else self.tick)
        self.iterations += 1
        t = self.clock

        for row, (slot, _start) in enumerate(plan.prefill):
            st = self.states[slot]
            st.pos += sched.page
            if st.pos < st.ln:
                continue
            # last chunk: the first generated token is born (TTFT moment)
            r = sched.active[slot]
            sched.lengths[slot] = st.ln
            sched.prefill_tokens += st.ln - st.skipped
            sched.cache_prefix(slot, r.prompt)
            first = int(first_toks[row])
            r.out.append(first)
            self.cur[slot] = first
            self.metrics.on_token(r.rid, t)
            self.states[slot] = None
            if (len(r.out) >= r.max_new
                    or int(sched.lengths[slot]) >= sched.max_len):
                self._maybe_truncate(r, slot)
                self._finish(slot, t)
            else:
                sched._reclaim_slot(slot)   # long prompts outrun the window

        for slot in plan.decode:
            r = sched.active[slot]
            if speculative:
                self._accept(slot, plan.verify.get(slot, []), preds[slot], t)
                continue
            sched.lengths[slot] += 1
            tok = int(nxt_tok[slot])
            r.out.append(tok)
            self.cur[slot] = tok
            self.metrics.on_token(r.rid, t)
            if (len(r.out) >= r.max_new
                    or int(sched.lengths[slot]) >= sched.max_len):
                self._maybe_truncate(r, slot)
                self._finish(slot, t)
            else:
                sched._reclaim_slot(slot)
        return True

    def _accept(self, slot: int, ks: List[int], preds: np.ndarray,
                t: float) -> None:
        """Acceptance and host rollback of one slot's verify window
        (``PagedScheduler.accept``), its tokens and outcome recorded at
        ``t``."""
        sched = self.sched
        r = sched.active[slot]
        accepted, emitted, finished = sched.accept(slot, ks, preds, self.cur)
        for _ in range(emitted):
            self.metrics.on_token(r.rid, t)
        self.metrics.on_spec_step(len(ks), accepted, emitted)
        if finished:
            self._maybe_truncate(r, slot)
            self._finish(slot, t)
        else:
            sched._reclaim_slot(slot)

    # ---------------------------------------------------------------- run
    def submit(self, requests: List[Request]) -> None:
        self.queue = ArrivalQueue(requests)

    def run(self, requests: Optional[List[Request]] = None) -> List[Request]:
        if requests is not None:
            self.submit(requests)
        while self.step():
            pass
        return self.done
