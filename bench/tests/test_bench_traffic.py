"""The traffic generator repeats from ``--seed`` (large seeds too), and a
scoring mix serves every seed the same lengths, in another order."""

from __future__ import annotations

import collections
import json

import numpy as np
import pytest

from conftest import BENCH
from yardstick import traffic

SEEDS = [0, 7, 2**31 + 5, 2**40 + 123]


def spec(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_from_the_seed(seed):
    s = spec("train-4x2048")
    a, b = (traffic.TrainTraffic(s, 49155, seed) for _ in range(2))
    for step in (0, 1, 17):
        x = a.batch(step)
        assert x.shape == (4, 2048) and x.dtype == np.int32
        assert np.array_equal(x, b.batch(step))
        assert (x == 0).sum(axis=1).min() >= 1       # document breaks
        assert x.min() >= 0 and x.max() < 49155
    assert not np.array_equal(a.batch(0), a.batch(1))
    other = traffic.TrainTraffic(s, 49155, seed + 1)
    assert not np.array_equal(a.batch(0), other.batch(0))
    assert np.array_equal(a.half_batch(3), a.batch(3)[:2])


@pytest.mark.parametrize("seed", SEEDS)
def test_score_batches_repeat_from_the_seed(seed):
    s = spec("score-longdoc")
    a, b = (traffic.ScoreTraffic(s, 32000, seed) for _ in range(2))
    for j in (0, 5, 13):
        pa, pb = a.batch(j), b.batch(j)
        assert len(pa) == 8
        assert all(np.array_equal(x, y) for x, y in zip(pa, pb))
        assert all(64 <= len(x) <= 4095 and x.min() >= 1 and x.max() < 32000
                   for x in pa)


def test_every_seed_serves_the_same_lengths_each_cycle():
    s = spec("score-longdoc")
    C = s["cycle_batches"]
    cycles = []
    for seed in SEEDS:
        t = traffic.ScoreTraffic(s, 32000, seed)
        for c in range(3):
            cycles.append(collections.Counter(
                tuple(sorted(t.lengths(c * C + k))) for k in range(C)))
    assert all(c == cycles[0] for c in cycles)
    orders = {tuple(len(p) for p in traffic.ScoreTraffic(s, 32000, seed)
                    .batch(0)) for seed in SEEDS}
    assert len(orders) > 1


def test_score_deck_is_the_lognormal_the_mix_states():
    s = spec("score-longdoc")
    lens = sorted(n for b in traffic.deck_lengths(s) for n in b)
    assert len(lens) == s["cycle_batches"] * s["batch"]
    assert np.median(lens) == pytest.approx(1024, rel=0.05)
    clipped = sum(n == 4095 for n in lens) / len(lens)
    assert 0.02 <= clipped <= 0.06                   # ~4% hit the clip
    assert min(lens) >= 64


def test_padded_row_is_the_engines_left_padding():
    row = traffic.padded_row(np.array([5, 6, 7]), 6)
    assert row.tolist() == [0, 0, 0, 5, 6, 7]


def test_warmup_holds_the_traffics_largest_shape():
    s = spec("score-longdoc")
    t = traffic.ScoreTraffic(s, 32000, 3)
    warm = t.warmup()
    longest = max(max(b) for b in traffic.deck_lengths(s))
    assert max(len(p) for p in warm[0]) == longest == 4095
