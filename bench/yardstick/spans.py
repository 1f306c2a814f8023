"""What the readers of the program's own spans and counters share.

The program (``repro_torch.obs.spans``) names its layers with
``record_function`` ranges, which land in the trace's host events on the
profiler's clock, and keeps a CUDA event pair a span and its counters in
a store of its own.  A program without that module gives these readers
nothing, and they return None.

A reader trusts the store only where the trace holds one unit span
(``train.step`` a traced step, ``serve.generate`` a traced batch) for each
traced unit.  Idle is the traced window less the device's busy intervals;
an idle reading intersects it with the union of some host spans.
"""

from __future__ import annotations

UNIT = {"train": "train.step", "score": "serve.generate"}

Intervals = list[tuple[float, float]]


def program():
    """The program's span store, or None where it has none."""
    try:
        from repro_torch.obs import spans
    except ImportError:
        return None
    return spans


def union(ivs) -> Intervals:
    """Sorted, disjoint intervals covering ``ivs``."""
    out: list[list[float]] = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a, b) -> Intervals:
    a, b = union(a), union(b)
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> Intervals:
    """``a`` less ``b``."""
    out = []
    b = union(b)
    for s, e in union(a):
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
        if e > s:
            out.append((s, e))
    return out


def length(ivs) -> float:
    return sum(e - s for s, e in ivs)


def host_spans(trace, name: str) -> Intervals:
    return [(s, e) for n, s, e in trace.host if n == name]


def units(rec, kind: str) -> int:
    """The number of traced units of a ``kind`` run whose unit spans the
    trace holds one each of; 0 where it does not."""
    if rec.kind != kind or rec.trace is None or not rec.traced:
        return 0
    n = len(host_spans(rec.trace, UNIT[kind]))
    return n if n == len(rec.traced) else 0


def device_ms(rec, kind: str, name: str) -> float | None:
    """Device milliseconds a traced unit in span ``name``."""
    n, store = units(rec, kind), program()
    if not n or store is None:
        return None
    ms = store.device_ms(name)
    return None if ms is None else ms / n


def idle_ms(rec, kind: str, inside: str | None,
            outside: str | None = None) -> float | None:
    """Device idle milliseconds a traced unit while the host was inside
    span ``inside`` (the whole window where None) and outside span
    ``outside``."""
    n = units(rec, kind)
    if not n or not rec.trace.kernels:
        return None
    tr = rec.trace
    idle = subtract([tr.window], tr.busy_intervals())
    region = [tr.window] if inside is None else host_spans(tr, inside)
    if outside is not None:
        region = subtract(region, host_spans(tr, outside))
    return length(intersect(idle, region)) * 1e3 / n


def counters(rec, kind: str) -> tuple[int, dict] | None:
    """(traced units, the program's counters) of a ``kind`` run."""
    n, store = units(rec, kind), program()
    if not n or store is None:
        return None
    return n, store.counters()
