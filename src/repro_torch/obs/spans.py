"""Named spans and counters inside the LM stack's train step and serving
engine, on the profiler's clock.

One switch: tracing is on exactly while a ``torch.profiler`` is recording
(``torch.autograd.profiler._is_profiler_enabled``); nothing else turns it
on.  Off, a span is one boolean test: no ``record_function``, no CUDA
event, no counter add.  On, a span

* enters ``record_function(name)``, so it shows in the profiler's host
  timeline beside the kernels;
* on a CUDA device, records a timing ``torch.cuda.Event`` on the current
  stream at entry and at exit and keeps the pair in this module's store.

``device_ms(name)`` synchronises once and sums ``elapsed_time`` over the
name's pairs: the device time from each span's entry to the end of its
last work, idle gaps inside it included.  Counters (``count``) add only
while tracing is on, so what the store holds after a traced window is
that window's.  ``reset()`` empties the store; ``counters()`` reads it.

The callers (``train/train_step.py``, ``serve/engine.py``) name what they
emit.  Spans sit at layer boundaries only, never inside a per-layer,
per-chunk or per-kernel loop.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs.metrics import Counter

_pairs: dict[str, list[tuple[torch.cuda.Event, torch.cuda.Event]]] = {}
_counters: dict[str, Counter] = {}
_OFF = contextlib.nullcontext()     # the span of an untraced call


class _On:
    __slots__ = ("name", "device", "rf", "start")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = None
        if self.device.type == "cuda":
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.device))
        return None

    def __exit__(self, *exc):
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            _pairs.setdefault(self.name, []).append((self.start, end))
        self.rf.__exit__(*exc)
        return False


def span(name: str, device: torch.device):
    """A context manager around one layer's call on ``device``."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, device)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _profiler._is_profiler_enabled:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter()
        c.inc(n)


def device_ms(name: str) -> float | None:
    """Device milliseconds summed over the pairs of span ``name``; None
    where no pair was recorded (no trace, or a CPU device)."""
    pairs = _pairs.get(name)
    if not pairs:
        return None
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs)


def counters() -> dict[str, float]:
    """Each counter's value."""
    return {k: c.value for k, c in _counters.items()}


def reset() -> None:
    """Forget every recorded pair and counter."""
    _pairs.clear()
    _counters.clear()
