"""Padded positions over padded and prompt positions of the traced
batches' prefills, by the engine's counters ``serve.padded_tokens`` and
``serve.prompt_tokens``."""

from yardstick import spans


def read(rec):
    got = spans.counters(rec, "score")
    if got is None:
        return None
    c = got[1]
    pad, prompt = c.get("serve.padded_tokens"), c.get("serve.prompt_tokens")
    if pad is None or prompt is None or pad + prompt == 0:
        return None
    return 100.0 * pad / (pad + prompt)
