"""The one generator of every cell's inputs, read from a mix file.

Serving (``"kind": "serve_open"``): an open loop.  Requests come in
blocks: first one that fills the lead-in (``lead_in_s`` x rate
requests), then blocks of ``block``.  A block of n holds the n quantiles
(at (i + 0.5) / n) of the prompt lengths, of the output lengths and of
the gaps between arrivals, and the seed only orders each of the three
within the block and draws the prompt tokens.  So every seed offers the
same work at the same rate, in another order, and a window that starts
with a block and lasts ``block`` / rate seconds sees the same lengths
for every seed.  The gaps are exponential quantiles scaled so that a
block lasts exactly n / rate seconds (Poisson arrivals, stratified).
Lengths are lognormal (median, sigma) clipped to [min, max].

Training (``"kind": "train"``): ``batch`` rows of ``seq_len + 1`` token
ids a step, each row drawn afresh from the seed and the step's index, ids
Zipf(``exponent``) over the vocabulary (id r - 1 for rank r), so that the
frequent ids repeat as in text.  Made on the device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class Request:
    rid: int
    due: float                 # seconds after the stream starts
    prompt: np.ndarray         # int32 token ids
    max_new: int


def quantiles(dist: Dict, n: int) -> np.ndarray:
    """The n stratified quantiles of a length distribution, as ints."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"length distribution {dist['dist']!r}")
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    v = np.round(dist["median"] * np.exp(dist["sigma"] * z))
    return np.clip(v, dist["min"], dist["max"]).astype(np.int64)


def gaps(rate: float, n: int) -> np.ndarray:
    """n exponential quantiles scaled to a mean of exactly 1 / rate."""
    g = np.array([-math.log(1.0 - (i + 0.5) / n) for i in range(n)])
    return g * (n / rate) / g.sum()


def serve_stream(mix: Dict, vocab: int, seed: int, horizon_s: float
                 ) -> List[Request]:
    """Requests due from 0 up to ``horizon_s`` seconds."""
    rate = float(mix["rate_per_s"])
    lead = int(round(float(mix.get("lead_in_s", 0.0)) * rate))
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t0, k = 0.0, 0
    while t0 < horizon_s:
        n = lead if k == 0 and lead else int(mix["block"])
        p = rng.permutation(quantiles(mix["prompt"], n))
        o = rng.permutation(quantiles(mix["output"], n))
        g = rng.permutation(gaps(rate, n))
        # a block's first arrival is at its start, its next block's start
        # lies one gap after its last arrival
        due = t0 + np.concatenate([[0.0], np.cumsum(g)[:-1]])
        for i in range(n):
            if due[i] >= horizon_s:
                return reqs
            prompt = rng.integers(0, vocab, int(p[i]), dtype=np.int64)
            reqs.append(Request(len(reqs), float(due[i]),
                                prompt.astype(np.int32), int(o[i])))
        t0 += n / rate
        k += 1
    return reqs


def zipf_cdf(vocab: int, exponent: float, device) -> torch.Tensor:
    w = torch.arange(1, vocab + 1, dtype=torch.float64,
                     device=device) ** (-exponent)
    c = torch.cumsum(w, 0)
    return (c / c[-1]).float()


def train_batch(mix: Dict, cdf: torch.Tensor, seed: int, step: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(tokens, labels), each (batch, seq_len) on ``cdf``'s device, of
    step ``step`` (counted from 1)."""
    b, s = int(mix["batch"]), int(mix["seq_len"])
    gen = torch.Generator(device=cdf.device)
    gen.manual_seed((int(seed) * 1_000_003 + step) % (2 ** 63))
    u = torch.rand((b, s + 1), generator=gen, device=cdf.device)
    ids = torch.searchsorted(cdf, u).clamp_(max=cdf.numel() - 1)
    ids = ids.to(torch.int32)
    return ids[:, :-1].contiguous(), ids[:, 1:].contiguous()
