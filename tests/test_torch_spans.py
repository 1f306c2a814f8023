"""The LM stack's spans and counters (``repro_torch.obs.spans``) in the
train step and the serving engine, on reduced granite-3-2b on the CPU.

Off (no profiler recording), a call leaves the store empty and makes no
``record_function`` and no CUDA event.  Under ``torch.profiler`` each span
shows by name, nested as the callers document, once a step, a microbatch,
a call or a decode step; the engine's counters count its padding and the
decode steps whose token it drops; and tokens, losses and parameters are
the same bits traced and untraced.  The CUDA event path runs here on fake
events.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.models import model as model_lib
from repro_torch.obs import spans
from repro_torch.optim import adamw
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train import train_step as ts

TRAIN_SPANS = ("train.step", "train.forward", "train.backward",
               "train.optimizer")
SERVE_SPANS = ("serve.generate", "serve.prefill", "serve.decode_step")


def _no_pairs():
    return all(spans.device_ms(n) is None for n in TRAIN_SPANS + SERVE_SPANS)


@pytest.fixture(autouse=True)
def _empty_store():
    spans.reset()
    yield
    spans.reset()


def _model():
    cfg = dataclasses.replace(registry.get("granite-3-2b").reduced(),
                              dtype="float32")
    model = model_lib.build(cfg, "cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _engine(max_len=32):
    model, params = _model()
    return model.cfg, Engine(model, params, ServeConfig(
        max_batch=4, max_len=max_len, temperature=0.0, eos_token=-1))


def _prompts(vocab, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [list(map(int, rng.integers(2, vocab, size=n))) for n in lengths]


def _trainer(microbatches=1):
    model, _ = _model()
    opt = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    state = ts.make_train_state(model, opt, torch.Generator().manual_seed(0))
    step = ts.make_train_step(model, opt, ts.TrainSettings(
        microbatches=microbatches))
    return model.cfg, state, step


def _batch(vocab, i):
    rng = np.random.default_rng(100 + i)
    return {"tokens": rng.integers(0, vocab, size=(4, 16))}


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events()]


def _named(events, name):
    return [(s, e) for n, s, e in events if n == name]


def _inside(child, parents):
    return all(any(ps <= s and e <= pe for ps, pe in parents)
               for s, e in child)


def test_untraced_calls_leave_no_trace(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an untraced call entered the tracing path")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    cfg, eng = _engine()
    eng.generate(_prompts(cfg.vocab_size, (3, 7, 5)), max_new=2)
    cfg, state, step = _trainer()
    step(state, _batch(cfg.vocab_size, 0))
    # a card's span is the same one test when off
    with spans.span("serve.generate", torch.device("cuda", 0)):
        pass
    assert _no_pairs() and spans.counters() == {}


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_spans_nest_once_a_step(microbatches):
    cfg, state, step = _trainer(microbatches)

    def run():
        s = state
        for i in range(2):
            s, metrics = step(s, _batch(cfg.vocab_size, i))
            float(metrics["loss"])
    _, events = _traced(run)
    steps = _named(events, "train.step")
    assert len(steps) == 2
    for name in ("train.forward", "train.backward"):
        assert len(_named(events, name)) == 2 * microbatches
    assert len(_named(events, "train.optimizer")) == 2
    for name in TRAIN_SPANS[1:]:
        assert _inside(_named(events, name), steps), name
    # on the CPU no event pair is kept
    assert _no_pairs()


@pytest.mark.parametrize("max_new", [1, 4])
def test_serve_spans_nest_once_a_call_and_a_step(max_new):
    cfg, eng = _engine()
    prompts = _prompts(cfg.vocab_size, (3, 7, 5, 9))
    _, events = _traced(lambda: [eng.generate(prompts, max_new=max_new)
                                 for _ in range(2)])
    calls = _named(events, "serve.generate")
    assert len(calls) == 2
    assert len(_named(events, "serve.prefill")) == 2
    assert len(_named(events, "serve.decode_step")) == \
        2 * eng.timing["decode_steps"]
    assert eng.timing["decode_steps"] == max_new
    for name in SERVE_SPANS[1:]:
        assert _inside(_named(events, name), calls), name


@pytest.mark.parametrize("lengths, max_len, max_new, dropped", [
    ((3, 7, 5, 9), 32, 1, 1),        # a step below max_len - 1, dropped
    ((31, 4, 20), 32, 1, 0),         # plen = max_len - 1: no step
    ((3, 7, 5, 9), 32, 4, 1),        # the step after the last kept token
    ((3, 7), 12, 8, 0),              # stops at max_len - 1, every step kept
])
def test_engine_counts_padding_and_dropped_steps(lengths, max_len, max_new,
                                                 dropped):
    cfg, eng = _engine(max_len)
    prompts = _prompts(cfg.vocab_size, lengths)
    out, _ = _traced(lambda: eng.generate(prompts, max_new=max_new))
    plen = max(lengths)
    assert spans.counters() == {
        "serve.prompt_tokens": sum(lengths),
        "serve.padded_tokens": len(lengths) * plen - sum(lengths),
        "serve.discarded_steps": dropped}
    kept = max(len(o) - len(p) for o, p in zip(out, prompts))
    assert eng.timing["decode_steps"] == kept - 1 + dropped


def test_tracing_changes_no_bit():
    cfg, eng = _engine()
    prompts = _prompts(cfg.vocab_size, (3, 7, 5, 9), seed=4)
    plain = eng.generate(prompts, max_new=4)
    traced, _ = _traced(lambda: eng.generate(prompts, max_new=4))
    assert traced == plain

    def steps(step, state):
        losses = []
        for i in range(2):
            state, metrics = step(state, _batch(cfg.vocab_size, i))
            losses.append(metrics["loss"])
        return state, losses

    cfg, state0, step = _trainer()
    plain_state, plain_loss = steps(step, state0)
    cfg, state1, step = _trainer()
    (traced_state, traced_loss), _ = _traced(lambda: steps(step, state1))
    assert all(torch.equal(a, b) for a, b in zip(plain_loss, traced_loss))
    for a, b in zip(tree.leaves(plain_state["params"]),
                    tree.leaves(traced_state["params"])):
        assert torch.equal(a, b)


class _FakeEvent:
    """A timing event stamped from a fake device clock."""
    clock = 0.0
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.clock

    def elapsed_time(self, end):
        return end.t - self.t


def test_device_ms_sums_the_event_pairs_of_a_card(monkeypatch):
    syncs = []
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(a))
    dev = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        for start, ms in ((0.0, 2.5), (10.0, 4.0)):
            _FakeEvent.clock = start
            with spans.span("serve.decode_step", dev):
                _FakeEvent.clock = start + ms
        spans.count("serve.discarded_steps", 1)
    assert spans.device_ms("serve.decode_step") == 6.5
    assert len(syncs) == 1 and _FakeEvent.made == 4
    assert spans.device_ms("train.step") is None
    assert spans.counters() == {"serve.discarded_steps": 1}
    # counters add only while tracing is on
    spans.count("serve.discarded_steps", 1)
    assert spans.counters() == {"serve.discarded_steps": 1}
    spans.reset()
    assert _no_pairs() and spans.counters() == {}
