"""Speculative decoding: draft -> verify -> accept/rollback, the port of
``repro/launch/speculative.py``.

The ragged multi-token prefill attention is exactly the shape of
verifying K draft tokens: a window of W = K + 1 candidate tokens per slot
scored causally against that slot's paged KV history
(``Model.verify_step_paged``).  This module supplies the pieces around
it; no kernel changes:

* **drafters** propose up to ``max_draft`` candidate continuations per
  slot from its prompt + emitted tokens:

  - :class:`NgramDrafter` -- model-free suffix matching: replay whatever
    followed the most recent earlier occurrence of the current n-token
    suffix.  A pure function of the history.
  - :class:`ModelDrafter` -- greedy autoregressive drafting with a small
    model sharing the target's token space.  The default draft
    (:func:`make_draft_config`, :func:`make_drafter`) is a truncated
    sibling of the target: its leading layers, with the target's own
    params for them, so drafting is early-exit self-speculation.

* **acceptance** (:func:`accept_longest_prefix`): draft ``d_j`` is
  accepted iff it equals the target's prediction at the row before it;
  the longest correct prefix plus the bonus token of the first
  disagreeing row is emitted.  Every verify step emits at least the token
  a plain decode step would have, so greedy speculative streams equal the
  non-speculative ones.

* **rollback** is the scheduler's business: the host advances ``lengths``
  only over the emitted tokens, and a rejected draft's K/V stays in the
  pool behind every later read's length.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ArchConfig


def accept_longest_prefix(drafts: Sequence[int],
                          predictions: np.ndarray) -> List[int]:
    """Longest-correct-prefix acceptance for one slot.

    ``drafts``: the K candidate tokens fed at window rows 1..K.
    ``predictions``: (W,) greedy argmax at every verify row; row t is the
    prediction for the token after window position t, so draft j (at row
    j + 1) is correct iff it equals ``predictions[j]``.  Returns the
    accepted drafts plus the bonus token from the first disagreeing row
    (with no drafts, exactly a decode step's argmax)."""
    a = 0
    while a < len(drafts) and int(drafts[a]) == int(predictions[a]):
        a += 1
    return [int(d) for d in drafts[:a]] + [int(predictions[a])]


class NgramDrafter:
    """Suffix-match drafting over each slot's prompt + emitted tokens.

    For the current ``n``-token suffix (falling back to shorter orders
    down to ``min_n``), find its most recent earlier occurrence in the
    history and propose the tokens that followed it."""

    name = "ngram"

    def __init__(self, *, max_draft: int = 3, n: int = 3, min_n: int = 1):
        if max_draft < 0:
            raise ValueError(f"max_draft must be >= 0, got {max_draft}")
        self.max_draft = int(max_draft)
        self.n = int(n)
        self.min_n = max(1, int(min_n))

    def _one(self, h: List[int]) -> List[int]:
        ln = len(h)
        for n in range(min(self.n, ln - 1), self.min_n - 1, -1):
            sfx = h[ln - n:]
            for j in range(ln - n - 1, -1, -1):
                if h[j:j + n] == sfx:
                    return h[j + n:j + n + self.max_draft]
        return []

    def propose(self, histories: Sequence[Sequence[int]]) -> List[List[int]]:
        return [self._one([int(t) for t in h]) for h in histories]


def make_draft_config(cfg: ArchConfig, n_layers: int = 0) -> ArchConfig:
    """A truncated sibling of ``cfg`` for drafting: same dims and token
    space, the leading ``n_layers`` of the layer stack (default: half, at
    least one)."""
    kinds = cfg.layer_kinds()
    n = n_layers or max(1, len(kinds) // 2)
    return dataclasses.replace(
        cfg.with_layers(kinds[:n]), name=cfg.name + "-draft")


class ModelDrafter:
    """Greedy autoregressive drafting with a small model.

    The draft model must share the target's token space; every proposal
    is verified by the target.  Drafting is stateless: each call
    right-pads the histories into a fixed (B, pad_to) buffer and runs
    ``max_draft`` whole forwards (the flash attention op), reading the
    logits row at each history's cursor (causality makes the padding
    inert).  Only that row goes through the final norm and the head, the
    same logits the JAX drafter takes from its full (B, pad_to, V) ones.
    The forwards run under ``torch.inference_mode``: no autograd state."""

    name = "model"

    def __init__(self, model, params, *, max_draft: int = 3,
                 pad_to: int = 128, batch_pad: int = 0):
        if max_draft < 0:
            raise ValueError(f"max_draft must be >= 0, got {max_draft}")
        self.model = model
        # int8 weights are quantized here, once (Model.bind_params)
        self.params = model.bind_params(params)
        self.max_draft = int(max_draft)
        self.pad_to = int(pad_to)
        self.batch_pad = int(batch_pad)

    def _padded_batch(self, b: int) -> int:
        if self.batch_pad:
            return max(self.batch_pad, b)
        n = 1
        while n < b:
            n *= 2
        return n

    def _next(self, toks: np.ndarray, last_idx: np.ndarray) -> np.ndarray:
        dev = self.model.device
        with torch.inference_mode():
            logits = self.model.prefill(
                self.params, {"tokens": torch.from_numpy(toks).to(dev)},
                last_idx=torch.from_numpy(last_idx).to(dev))
            return torch.argmax(logits, dim=-1).cpu().numpy()

    def propose(self, histories: Sequence[Sequence[int]]) -> List[List[int]]:
        b = len(histories)
        if b == 0 or self.max_draft == 0:
            return [[] for _ in range(b)]
        bp = self._padded_batch(b)
        toks = np.zeros((bp, self.pad_to), np.int32)
        cursor = np.ones((bp,), np.int32)     # padded rows: 1-token history
        for j, h in enumerate(histories):
            h = [int(t) for t in h][-self.pad_to:]   # keep the suffix
            toks[j, :len(h)] = h
            cursor[j] = len(h)
        out: List[List[int]] = [[] for _ in range(b)]
        for _ in range(self.max_draft):
            if int(cursor.max()) >= self.pad_to:
                break
            nxt = self._next(toks, cursor - 1)
            for j in range(b):
                t = int(nxt[j])
                out[j].append(t)
                toks[j, cursor[j]] = t
            cursor += 1
        return out


def draft_params(target, target_params, n_layers: int):
    """The truncated sibling's params: the target's embedding, final norm
    and head, and its first ``n_layers`` layers in execution order (across
    its prefix, stacked periods and tail) as the draft's prefix layers.
    The JAX package gets the same network by initializing the draft from
    the target's key, which it folds per layer index; the port's
    ``Model.init`` draws from one sequential generator, so the draft takes
    the target's tensors instead."""
    out = {k: v for k, v in target_params.items()
           if k not in ("prefix", "stack", "tail")}
    out.update(prefix=target.leading_layers(target_params, n_layers),
               stack=[], tail=[])
    return out


def make_drafter(kind: str, cfg: ArchConfig, *, max_draft: int = 3,
                 dt=None, target=None, target_params=None,
                 draft_layers: int = 0, pad_to: int = 128,
                 batch_pad: int = 0, model: Optional[object] = None,
                 params=None):
    """Build a drafter by name ("ngram" | "model") for a target arch.

    For ``"model"``, pass the draft ``model``/``params`` explicitly, or
    the target ``Model`` and its (unbound) params to build the truncated
    sibling (:func:`make_draft_config`) on the target's device from the
    target's leading layers (:func:`draft_params`)."""
    if kind == "ngram":
        return NgramDrafter(max_draft=max_draft)
    if kind == "model":
        if model is None:
            from ..models.transformer import Model
            if target is None or target_params is None:
                raise ValueError("a model drafter needs model= and params=, "
                                 "or target= and target_params=")
            dcfg = make_draft_config(cfg, draft_layers)
            model = Model(dcfg, dt=dt or target.dt, device=target.device)
            params = draft_params(target, target_params, dcfg.n_layers)
        if model.cfg.vocab_size != cfg.vocab_size:
            raise ValueError(
                f"draft arch {model.cfg.name} vocab "
                f"{model.cfg.vocab_size} != target vocab {cfg.vocab_size} "
                "(drafter and target must share the token space)")
        return ModelDrafter(model, params, max_draft=max_draft,
                            pad_to=pad_to, batch_pad=batch_pad)
    raise ValueError(f"unknown drafter {kind!r} (want ngram|model)")
