"""Decode steps a traced batch whose sampled token ``Engine.generate``
does not return, by the engine's counter ``serve.discarded_steps``."""

from yardstick import spans


def read(rec):
    got = spans.counters(rec, "score")
    if got is None or "serve.discarded_steps" not in got[1]:
        return None
    n, c = got
    return c["serve.discarded_steps"] / n
