"""The mixes' generator: seeded, the same work for every seed, and the
lengths the mix file states."""
import json

import numpy as np
import pytest
import torch

from benchlib import traffic
from tiny import BENCH

MIX = json.loads((BENCH / "mixes" / "code.open.json").read_text())
TRAIN = json.loads((BENCH / "mixes" / "train.2k.json").read_text())
ZIPF = TRAIN["tokens"]["exponent"]


def stream(seed, horizon=60.0):
    return traffic.serve_stream(MIX, 92416, seed, horizon)


def test_same_seed_same_stream():
    a, b = stream(2 ** 31 + 5), stream(2 ** 31 + 5)
    assert [r.due for r in a] == [r.due for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert [r.max_new for r in a] == [r.max_new for r in b]


def test_seeds_reorder_the_same_work():
    rate, n = MIX["rate_per_s"], MIX["block"]
    lead = round(MIX["lead_in_s"] * rate)
    sizes = [lead, n, n]
    horizon = MIX["lead_in_s"] + 2 * n / rate
    a, b = stream(1, horizon), stream(2, horizon)
    assert len(a) == len(b) == sum(sizes)
    start, t0 = 0, 0.0
    for size in sizes:
        blk_a, blk_b = a[start:start + size], b[start:start + size]
        assert sorted(len(r.prompt) for r in blk_a) == \
            sorted(len(r.prompt) for r in blk_b)
        assert sorted(r.max_new for r in blk_a) == \
            sorted(r.max_new for r in blk_b)
        # a block starts on time and lasts size / rate seconds
        assert blk_a[0].due == blk_b[0].due == pytest.approx(t0)
        assert all(t0 <= r.due < t0 + size / rate for r in blk_a + blk_b)
        start, t0 = start + size, t0 + size / rate
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]


def test_the_window_sees_one_block():
    """A window opening after the lead-in and lasting block / rate seconds
    holds the same lengths for every seed."""
    rate, n = MIX["rate_per_s"], MIX["block"]
    t_open = MIX["lead_in_s"]
    seen = []
    for seed in (5, 6):
        s = stream(seed, t_open + 2 * n / rate)
        seen.append(sorted(len(r.prompt) for r in s
                           if t_open <= r.due < t_open + n / rate))
    assert seen[0] == seen[1] and len(seen[0]) == n


def test_lengths_follow_the_mix():
    for dist in (MIX["prompt"], MIX["output"]):
        v = traffic.quantiles(dist, 32)
        assert v.min() >= dist["min"] and v.max() <= dist["max"]
        assert abs(np.median(v) - dist["median"]) <= 0.1 * dist["median"]
        assert np.all(np.diff(v) >= 0)
    # the stated medians (Splitwise's coding trace), clipped only in the
    # tails
    assert MIX["prompt"]["median"] == 1500 and MIX["output"]["median"] == 13
    assert traffic.quantiles(MIX["prompt"], 32).max() == MIX["prompt"]["max"]


def test_gaps_are_exponential_quantiles_at_the_rate():
    g = traffic.gaps(4.0, 32)
    assert abs(g.sum() - 8.0) < 1e-9
    assert np.all(np.diff(g) > 0)


def test_prompts_stay_in_the_vocabulary():
    for r in stream(9):
        assert r.prompt.dtype == np.int32
        assert r.prompt.min() >= 0 and r.prompt.max() < 92416


def test_train_batches_are_seeded_and_differ():
    mix = {"batch": 2, "seq_len": 64}
    cdf = traffic.zipf_cdf(1000, 1.1, "cpu")
    a = traffic.train_batch(mix, cdf, 2 ** 33 + 1, 1)
    b = traffic.train_batch(mix, cdf, 2 ** 33 + 1, 1)
    c = traffic.train_batch(mix, cdf, 2 ** 33 + 1, 2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0][0], a[0][1])
    assert torch.equal(a[0][:, 1:], a[1][:, :-1])     # labels shift by one
    assert int(a[0].max()) < 1000 and int(a[0].min()) >= 0


def test_zipf_ids_repeat_the_frequent_ones():
    cdf = traffic.zipf_cdf(151936, ZIPF, "cpu")
    ids, _ = traffic.train_batch(TRAIN, cdf, 3, 1)
    counts = torch.bincount(ids.flatten().long())
    assert int(counts[0]) > 100            # rank 1 takes ~1/H(1.0) of ids
    assert int(counts.argmax()) == 0
