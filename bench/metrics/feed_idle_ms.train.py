"""Device idle time a traced step while the host was outside every
``train.step`` span: the caller's feed and loss read, the time the card
waits for data."""

from yardstick import spans


def read(rec):
    return spans.idle_ms(rec, "train", None, "train.step")
