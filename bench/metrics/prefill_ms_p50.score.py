"""Median of ``Engine.timing["prefill_s"]`` over the window's batches:
the engine's host clock around its prefill, which ends in the copy of the
sampled tokens to the host (``serve/engine.py``)."""

import statistics


def read(rec):
    if rec.kind != "score" or not rec.prefill_s:
        return None
    return statistics.median(rec.prefill_s) * 1e3
