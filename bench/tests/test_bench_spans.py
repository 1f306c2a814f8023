"""The readers of the program's spans and counters (``metrics/*`` over
``yardstick/spans.py``), on a record and a trace built by hand with
kernels and host spans at known times, and the program's span store
filled through its own API on fake CUDA events.  Times are binary
fractions, so each reading is exact."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from conftest import BENCH
from yardstick import cell as cell_lib
from yardstick import drivers
from yardstick import spans as yspans
from yardstick import trace as trace_lib

TRAIN = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
         "feed_idle_ms.train")
SCORE = ("decode_ms.score", "engine_idle_ms.score", "prefill_idle_ms.score",
         "padded_share.score", "discarded_steps.score")


def _reader(name):
    return cell_lib.load_module(BENCH / "metrics" / f"{name}.py",
                                f"spans_reader_{name.replace('.', '_')}")


class _FakeEvent:
    clock = 0.0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.clock

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def store(monkeypatch):
    """The program's store, empty, on fake CUDA events; ``fill`` records
    spans of the given device milliseconds and adds counts, traced."""
    from repro_torch.obs import spans

    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    spans.reset()

    def fill(ms: dict, counts: dict = {}):
        dev = torch.device("cuda", 0)
        with profile(activities=[ProfilerActivity.CPU]):
            for name, times in ms.items():
                for t in times:
                    _FakeEvent.clock = 0.0
                    with spans.span(name, dev):
                        _FakeEvent.clock = t
            for name, n in counts.items():
                spans.count(name, n)

    yield fill
    spans.reset()


def _train_record(units=2):
    """Steps at [1, 3] and [5, 7] s of an [0, 8] window; the device busy
    over [1.5, 3.5] and [5.5, 7.25]."""
    host = [("train.step", 1.0, 3.0), ("aten::mm", 1.25, 1.5),
            ("train.step", 5.0, 7.0)]
    kernels = [("gemm", 1.5, 3.5), ("add", 5.5, 7.25)]
    rec = drivers.Record("train", {}, {}, 1.0, [], [], [])
    rec.trace = trace_lib.Trace(kernels, host, (0.0, 8.0))
    rec.traced = [{} for _ in range(units)]
    return rec


def _score_record(units=2):
    """Two calls at [1, 4] and [5, 8] s of a [0, 9] window, their
    prefills at [1.5, 2.5] and [5.5, 6.5]."""
    host = [("serve.generate", 1.0, 4.0), ("serve.prefill", 1.5, 2.5),
            ("serve.generate", 5.0, 8.0), ("serve.prefill", 5.5, 6.5),
            ("serve.decode_step", 2.5, 3.5)]
    kernels = [("fa_fwd", 1.75, 2.25), ("gemm", 2.5, 3.5),
               ("gemm", 5.75, 6.0), ("add", 6.5, 8.0)]
    rec = drivers.Record("score", {}, {}, 1.0, [], [], [[4, 2], [3, 3]])
    rec.trace = trace_lib.Trace(kernels, host, (0.0, 9.0))
    rec.traced = [{} for _ in range(units)]
    return rec


TRAIN_MS = {"train.forward": [100.0, 120.0], "train.backward": [200.0, 250.0],
            "train.optimizer": [50.0, 50.0]}
SCORE_MS = {"serve.decode_step": [3.0, 5.0]}
SCORE_COUNTS = {"serve.prompt_tokens": 300, "serve.padded_tokens": 100,
                "serve.discarded_steps": 1}


def test_train_readers_read_the_store_and_the_idle_outside_steps(store):
    store(TRAIN_MS)
    rec = _train_record()
    got = {m: _reader(m).read(rec) for m in TRAIN}
    # idle [0, 1.5], [3.5, 5.5], [7.25, 8]; outside the steps [0, 1],
    # [3.5, 5], [7.25, 8]: 3.25 s over 2 steps
    assert got == {"forward_ms.train": 110.0, "backward_ms.train": 225.0,
                   "optimizer_ms.train": 50.0, "feed_idle_ms.train": 1625.0}
    # a scoring run gives them nothing
    assert all(_reader(m).read(_score_record()) is None for m in TRAIN)


def test_score_readers_read_the_store_the_counters_and_the_idle(store):
    store(SCORE_MS, SCORE_COUNTS)
    rec = _score_record()
    got = {m: _reader(m).read(rec) for m in SCORE}
    # idle [0, 1.75], [2.25, 2.5], [3.5, 5.75], [6, 6.5], [8, 9]; inside
    # the prefills 0.25 + 0.25 + 0.25 + 0.5 s; inside the calls outside
    # the prefills [1, 1.5], [3.5, 4], [5, 5.5]: 1.5 s
    assert got == {"decode_ms.score": 4.0, "engine_idle_ms.score": 750.0,
                   "prefill_idle_ms.score": 625.0,
                   "padded_share.score": 25.0,
                   "discarded_steps.score": 0.5}
    assert all(_reader(m).read(_train_record()) is None for m in SCORE)


@pytest.mark.parametrize("name", TRAIN + SCORE)
def test_readers_are_silent_without_a_trace_or_a_unit_span_a_unit(store,
                                                                  name):
    store({**TRAIN_MS, **SCORE_MS}, SCORE_COUNTS)
    make = _train_record if name.endswith(".train") else _score_record
    assert _reader(name).read(make()) is not None
    untraced = make()
    untraced.trace = None
    assert _reader(name).read(untraced) is None
    # one unit more than the trace holds unit spans, or one fewer
    assert _reader(name).read(make(units=3)) is None
    assert _reader(name).read(make(units=1)) is None


@pytest.mark.parametrize("name", TRAIN + SCORE)
def test_readers_are_silent_on_a_program_without_spans(monkeypatch, name):
    """The parent of the spans: no store, and no span in the trace."""
    monkeypatch.setattr(yspans, "program", lambda: None)
    make = _train_record if name.endswith(".train") else _score_record
    rec = make()
    rec.trace.host = [h for h in rec.trace.host
                      if not h[0].startswith(("train.", "serve."))]
    assert _reader(name).read(rec) is None


def test_readers_are_silent_on_the_cpu_with_no_kernels(store):
    store(TRAIN_MS)
    rec = _train_record()
    rec.trace.kernels = []
    assert _reader("feed_idle_ms.train").read(rec) is None


def test_interval_arithmetic():
    assert yspans.union([(3, 4), (0, 1), (0.5, 2), (5, 5)]) == \
        [(0, 2), (3, 4)]
    assert yspans.intersect([(0, 2), (3, 6)], [(1, 4), (5, 7)]) == \
        [(1, 2), (3, 4), (5, 6)]
    assert yspans.subtract([(0, 10)], [(1, 2), (4, 5), (9, 12)]) == \
        [(0, 1), (2, 4), (5, 9)]
    assert yspans.length([(0, 1), (2, 4.5)]) == 3.5
