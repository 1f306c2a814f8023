"""Device idle time a traced batch while the host was inside
``serve.prefill`` (the ``Model.prefill`` call): the prefill's launch
gaps."""

from yardstick import spans


def read(rec):
    return spans.idle_ms(rec, "score", "serve.prefill")
