"""Host data pipeline: deterministic synthetic LM shards with prefetch.
A copy of ``repro/data/pipeline.py`` (numpy only; the port may not import
the JAX package), so its batches are bit-identical to the JAX package's.

Paper tie-ins:
* memory access extraction (§4.1): batch generation runs on a background
  thread, decoupled from the accelerator step loop — compute never waits on
  the "memory module";
* memory oversubscription (§4.2): the prefetch queue holds ``prefetch``
  batches ahead of the consumer;
* striping (§4.3): each host generates only its own shard of the global
  batch (deterministic in (seed, step, host) so restarts resume exactly).

The synthetic stream is a Zipf-ish token mixture with a Markov flavor — it
has enough learnable structure that loss decreases (used by the end-to-end
example to demonstrate real training), while being fully reproducible
offline.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2          # §4.2 oversubscription depth
    input_mode: str = "tokens"
    d_model: int = 0           # for embeddings mode

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Deterministic synthetic language modeling stream.

    Token t+1 = (a * token_t + drift) mod V with noise — a learnable
    first-order structure.  Every (seed, step, host, row) is independent,
    so any host can regenerate any batch (elastic restarts, §fault
    tolerance)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 1009 + cfg.host_id)
        b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
        start = rng.integers(0, v, size=(b, 1))
        mult = 31 if v > 31 else 3
        toks = [start]
        for _ in range(s):
            nxt = (toks[-1] * mult + 7) % v
            noise = rng.integers(0, v, size=(b, 1))
            take_noise = rng.random((b, 1)) < 0.1
            toks.append(np.where(take_noise, noise, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)  # (b, s+1)
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if cfg.input_mode == "embeddings":
            emb = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
            batch = {"embeddings": emb, "labels": seq[:, 1:]}
        return batch


def make_pipeline(cfg: DataConfig, start_step: int = 0,
                  stop_event: Optional[threading.Event] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator (§4.1 + §4.2)."""
    src = SyntheticLM(cfg)
    q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
    stop = stop_event or threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(src.batch_at(step), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    return gen()
