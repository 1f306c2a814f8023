"""Device idle time a traced batch while the host was inside
``serve.generate`` but outside ``serve.prefill``: the cache fill, padding,
sampling, host copies and the decode step."""

from yardstick import spans


def read(rec):
    return spans.idle_ms(rec, "score", "serve.generate", "serve.prefill")
